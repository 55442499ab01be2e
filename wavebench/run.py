"""Run one cell of the benchmark on one card and print its result line.

    python3 wavebench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The last line of standard output is the
result's JSON object; the numbers compared for ``correct`` are also the
last lines of standard error. Exits 1 with no result when there is no
card, when the cell needs more cards than there are, or when JAX or the
JAX package was loaded. ``--control`` judges the check's control in the
program's place (``correct`` must then read false) and adds the program's
own numbers and the faults' readings; the benchmark's own runs do not.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "wavebench" / ".cache"


def pin_caches():
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    # few host threads: the sender thread, the pool's worker and the
    # launches share the host's cores with torch's intra-op pool
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    a = ap.parse_args(argv)
    pin_caches()
    sys.path.insert(0, str(ROOT))
    import torch

    from wavebench import bench, spec

    cell = spec.load_cell(a.workload)
    chips = next(w.get("chips", 1) for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]
        if w["name"] == a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"wavebench: the cell needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    import pytorch_wavenet_tpu_torch  # noqa: F401  (fails without the port)

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = bench.run_cell(cell, a.seed, a.seconds, bool(a.trace), device,
                            T_PROCESS, control=a.control)
    found = bench.forbidden_modules()
    if found:
        print(f"wavebench: the run loaded {found}", file=sys.stderr)
        return 1
    x = result.pop("notes")
    print("run: " + ", ".join(f"{k} {v!r}" for k, v in sorted(x.items())),
          file=sys.stderr)
    if "late_max_ms" in x:
        print(f"the generator sent at most {x['late_max_ms']:.3f} ms late",
              file=sys.stderr)
    for k, c in result["compared"].items():
        print(f"compared {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
