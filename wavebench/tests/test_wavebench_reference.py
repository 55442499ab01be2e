"""The plain reference against the port's plain path at the tiny preset:
the teacher-forced logits, the sampling noise, the served classes of the
pool (K4's plain version) and of one stream (K1's)."""

import numpy as np
import torch

from wavebench import inputs
from wavebench.loads.stream import decode_table, kernel_seed, to_classes
from wavebench.reference import judge, noise, wavenet
from wavebench.tests.helpers import TINY


def _cfg(**over):
    from wavebench.loads import port_config

    return port_config(TINY, **over)


def test_logits_match_the_port():
    from pytorch_wavenet_tpu_torch.models.wavenet import wavenet_logits

    p = inputs.make_weights(TINY, 3, "cpu")
    x = inputs.make_signal(3, 200, 32, "cpu")[None]
    ours = wavenet.logits(p, TINY, x, 200)
    port = wavenet_logits(p, _cfg(), x, 200)
    assert torch.allclose(ours, port, atol=1e-5, rtol=1e-5)
    assert wavenet.receptive_field(TINY) == _cfg().receptive_field


def test_noise_matches_the_port():
    from pytorch_wavenet_tpu_torch.ops.cuda.gen_kernel import counter_uniform

    cls = torch.arange(256)[None, :]
    step = torch.arange(-3, 40)[:, None]
    for seed in (0, 5, -7, 2**31 - 1, 2**32 + 9):
        assert torch.equal(noise.uniform(cls, step, seed),
                           counter_uniform(cls, step, seed, "cpu"))


def test_tf32_rounding_keeps_ten_bits():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10, -3.0 - 2**-9 - 2**-12])
    r = wavenet.tf32_round(x)
    assert r[1] == x[1] and r[0] in (1.0, 1.0 + 2**-10)
    assert abs(float(r[2] - x[2])) <= 2**-10


def test_pool_tokens_agree_with_the_reference():
    from pytorch_wavenet_tpu_torch.ops.cuda.gen_kernel_hbm import (
        generate_fast_batched)

    p = inputs.make_weights(TINY, 4, "cpu")
    sig = inputs.make_signal(4, 500, 32, "cpu")
    prime = sig[:20].to(torch.int32)
    checked = []
    for temp, seed in ((1.0, 77), (0.0, 5), (0.7, -3)):
        _, cls = generate_fast_batched(
            p, _cfg(), None, 60, prime[None], temperature=temp,
            lane_seed=torch.tensor([seed]), fuse_res=True, skip_slab=True,
            device="cpu")
        checked.append((prime.numpy(), cls[0].numpy(), temp,
                        seed & 0xFFFFFFFF))
    res = judge.judge_served(p, TINY, checked, "cpu", control=True)
    assert res["gap"] < 1e-5 and res["positions"] == 180
    assert res["fault_gap"] > 1e-3


def test_stream_tokens_agree_with_the_reference():
    from pytorch_wavenet_tpu_torch.serving.server import Synthesizer

    p = inputs.make_weights(TINY, 5, "cpu")
    sig = inputs.make_signal(5, 500, 32, "cpu").numpy()
    synth = Synthesizer(p, _cfg(), device="cpu")
    prime = sig[:30].astype(np.int32)
    wav = np.concatenate(list(synth.stream(50, 1.0, 1234, 16, prime=prime)))
    cls = to_classes(wav, 32)
    assert np.allclose(decode_table(32)[cls], wav, atol=1e-6)
    res = judge.judge_served(p, TINY, [(prime, cls, 1.0, kernel_seed(1234))],
                             "cpu")
    assert res["gap"] < 1e-5
