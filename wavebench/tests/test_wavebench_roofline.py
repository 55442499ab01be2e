"""The yardstick's counts against the hand counts."""

import pytest

from wavebench import roofline, spec


# a 40-layer model with 32 channels everywhere and no bias, whose chain of
# layers holds most of a sample's operations
CHAIN = dict(layers=10, blocks=4, dilation_channels=32, residual_channels=32,
             skip_channels=32, end_channels=32, classes=256, kernel_size=2,
             bias=False)


def _model(name):
    return spec._read(spec.BENCH_DIR / "configs" / f"{name}.json")["model"]


def test_step_flops_by_hand():
    # chaconne: chain 2*30*(2*32*64 + 32*32) = 307,200; skip 2*30*32*1024
    # = 1,966,080; head 2*(1024*512 + 512*256) = 1,310,720
    assert roofline.step_flops(_model("chaconne")) == 3_584_000
    # CHAIN: chain 2*40*(4096 + 1024) = 409,600; skip 81,920; head 18,432
    assert roofline.step_flops(CHAIN) == 509_952


def test_param_count_matches_the_layout():
    from wavebench import inputs

    for m in (_model("chaconne"), CHAIN):
        n = sum(int(v.numel()) for t in inputs.make_weights(m, 1, "cpu")
                .values() for v in t.values())
        assert roofline.param_count(m) == n


def test_gen_bound_is_operations_bound_for_a_full_pool():
    m = _model("chaconne")
    t, why = roofline.gen_bound_s(m, 256 * 2048, 1, 256)
    assert why == "operations"
    assert t == pytest.approx(256 * 2048 * 3_584_000 / 495e12)
