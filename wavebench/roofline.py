"""Operations and bytes of the work the inputs need, and the H100's peaks.

Counts follow the configuration, not an implementation, so that no later
change to a kernel makes the yardstick stale: every product counts once
(2 * M * K * N), at the one peak of the configuration's precision (f32
products: the dense TF32 tensor-core rate), never as 3xTF32 triples; the
bytes are each launch's weights and state read once and written once.
Rewritten from ``utils/profiling.py::generation_step_flops`` and
``chip_smoke.py::bound_ms``, frozen here.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense, at the full 700 W (NVIDIA's data sheet)
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def _dims(m: dict):
    L = m["layers"] * m["blocks"]
    return (L, m.get("kernel_size", 2), m["residual_channels"],
            m["dilation_channels"], m["skip_channels"], m["end_channels"],
            m.get("classes", 256))


def dilations(m: dict) -> list:
    return [2 ** (i % m["layers"]) for i in range(m["layers"] * m["blocks"])]


def peak(m: dict) -> float:
    return PEAK_FLOPS[m.get("compute_dtype", "float32")]


def param_count(m: dict) -> int:
    L, k, R, D, S, E, C = _dims(m)
    n = C * R + L * (k * R * 2 * D + D * R + D * S) + S * E + E + E * C + C
    if m.get("bias", False):
        n += R + L * (2 * D + R + S)
    return n


def step_flops(m: dict) -> int:
    """One generation step: every layer's taps and residual, the skip
    projection, the head (3,584,000 at chaconne; 509,952 at 40 layers of
    32 channels)."""
    L, k, R, D, S, E, C = _dims(m)
    return 2 * L * (k * R * 2 * D + D * R) + 2 * L * D * S + 2 * (S * E
                                                                  + E * C)


def state_bytes(m: dict, lanes: int = 1) -> int:
    """A stream's history: (k-1) * d_l inputs of R floats for each layer."""
    L, k, R, *_ = _dims(m)
    return 4 * lanes * R * (k - 1) * sum(dilations(m))


def gen_bound_s(m: dict, steps: int, launches: int,
                lane_launches: int) -> tuple:
    """Least time of ``steps`` useful lane-steps (samples generated and
    prime classes ingested) over ``launches`` launches that carried
    ``lane_launches`` lanes in all: ``(seconds, "operations" |
    "bytes")``."""
    t_ops = steps * step_flops(m) / peak(m)
    nbytes = (launches * 4 * param_count(m)
              + 2 * lane_launches * state_bytes(m))
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")

