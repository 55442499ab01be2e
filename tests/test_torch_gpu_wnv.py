"""The wide-chain kernel KW (``ops/cuda/gen_kernel_wide.py``) on a card
(marked ``gpu``; each test skips without one), one test a check of
``scripts/torch_wide_check.py``, the one copy of them: against its plain
version at ``tiny_wnv`` and ``wnv512``, a lane's bits at 1, 40 and 256
lanes, the timers' split, the lane pool in frames mode against one
``generate_fast_batched`` call, one stream through ``generate_fast_fused``,
and chaconne still on K4.

This file imports neither JAX nor the JAX package: ``python -m pytest
--noconftest -m gpu tests/test_torch_gpu_wnv.py``."""

import importlib.util
import pathlib

import pytest
import torch

_spec = importlib.util.spec_from_file_location(
    "torch_wide_check",
    pathlib.Path(__file__).parents[1] / "scripts" / "torch_wide_check.py")
wc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(wc)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip; see README)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _passes(check, *args):
    """Runs one check; it passes if it adds no failure."""
    n = len(wc.failures)
    out = check(*args)
    assert wc.failures[n:] == []
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("case", wc.PLAIN_CASES)
def test_wide_kernel_matches_plain_on_card(card, case):
    """Classes agree off near-ties of the plain version's scores, rings
    within 1e-4 (the two sum in different orders), the previous-class row
    exactly."""
    _passes(wc.against_plain, card, *case)


@pytest.mark.gpu
@pytest.mark.parametrize("case", wc.LANE_BITS_CASES)
def test_lane_bits_at_any_lane_count(card, case):
    _passes(wc.lane_bits, card, *case)


@pytest.mark.gpu
def test_pool_frames_mode_equals_one_call_on_card(card):
    pool = _passes(wc.pool_vs_solo, card)
    assert pool["launches"] >= pool["stats"]["pool_steps"] > 0


@pytest.mark.gpu
def test_wide_timers_split(card):
    _passes(wc.timing, card, 16)


@pytest.mark.gpu
def test_one_stream_runs_the_wide_kernel(card):
    _passes(wc.one_stream, card)


@pytest.mark.gpu
def test_chaconne_stays_on_k4(card):
    _passes(wc.chaconne_k4, card)
