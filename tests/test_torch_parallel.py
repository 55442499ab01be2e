"""The port's data- and model-parallel layer against the JAX package on the
CPU: meshes of 2 and 4 gloo ranks (one process each, started once per
world size by ``torch_parallel_cases.spawn``), compared here with the JAX
package's functions on the global batch and with the port on one rank.

Forward and ``parallel_train_step`` at meshes (2, 1), (1, 2) and (2, 2)
equal JAX ``train_step`` on the global batch at atol = rtol = 1e-5 (the
plain trunk, the trunk kernel's plain versions and the conditioned
vocoder); under ``model = 2`` the clipped Adam, ``sgd_normalized`` and the
gradients equal one rank's (a factor of ``model`` or a per-block norm
would show); ``sharded_pool_step`` over 4 ranks equals the unsharded pool
step bitwise, chained twice; the sharded generation and the sharded batch
iterator give the global results.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_wavenet_tpu as wt
import pytorch_wavenet_tpu_torch as pt
import torch_parallel_cases as cases
from pytorch_wavenet_tpu.parallel.sharding import param_pspecs as jax_pspecs
from pytorch_wavenet_tpu.training.optimizers import reference_adam as jadam
from pytorch_wavenet_tpu.training.trainer import train_step as jax_step
from pytorch_wavenet_tpu_torch.parallel import mesh as pmesh
from pytorch_wavenet_tpu_torch.parallel import sharding
from pytorch_wavenet_tpu_torch.training import optimizers as topt

TOL = dict(atol=1e-5, rtol=1e-5)
MESHES = ("21", "12", "22")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both world sizes' cases, run once: the output directory."""
    d = str(tmp_path_factory.mktemp("parallel"))
    audio = os.path.join(d, "audio")
    os.makedirs(audio)
    pt.write_wav(os.path.join(audio, "t.wav"),
                 0.3 * np.sin(np.arange(32000) * 0.05), 16000)
    ds_file = os.path.join(d, "ds.npz")
    pt.WaveNetDataset(dataset_file=ds_file, item_length=64, target_length=8,
                      file_location=audio, test_stride=50)
    cases.spawn("w2", 2, d, ds_file)
    cases.spawn("w4", 4, d, ds_file)
    return d


@pytest.fixture(scope="module")
def jax_steps():
    """JAX ``train_step`` on the global batch for each step config: (loss,
    params) as numpy; the trunk-kernel case through JAX's fused trunk (in
    interpret mode), whose saves the port's K2/K3 plain versions round as
    it does."""
    out = {}
    for name, tcfg in cases.step_configs().items():
        cfg = wt.get_config("tiny_vocoder" if name == "cond" else "tiny",
                            trunk_kernel=name == "tk")
        npp = cases.params_of(tcfg)
        x, y, cond = cases.batch(tcfg)
        p = jax.tree.map(jnp.asarray, npp)
        tx = jadam(cases.LR)
        p1, _, loss, _ = jax_step(
            jax.tree.map(jnp.copy, p), tx.init(p), cfg, tx, jnp.asarray(x),
            jnp.asarray(y), None if cond is None else jnp.asarray(cond))
        out[name] = (np.asarray(loss), cases.flat(
            jax.tree.map(np.asarray, p1)))
    return out


def _tree_close(got: dict, prefix: str, want: dict, tol=TOL):
    keys = [k for k in got if k.startswith(prefix)]
    assert sorted(k[len(prefix):] for k in keys) == sorted(want)
    for k in keys:
        np.testing.assert_allclose(got[k], want[k[len(prefix):]], **tol,
                                   err_msg=k)


def test_make_mesh_shapes_and_refusals(runs):
    m = pmesh.make_mesh(1, 1)
    assert pmesh.mesh_shape(m) == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="2x1 != 1"):
        pmesh.make_mesh(2, 1)  # no process group: one rank
    got = cases.load(runs, "mesh", 1)
    assert "mesh 2x2 != 2 ranks" in str(got["refused"])


@pytest.mark.parametrize("name", ["tiny", "tiny_vocoder"])
def test_param_pspecs_equal_jax(name):
    over = {"cond_upsample": (2, 2)} if name == "tiny_vocoder" else {}
    jcfg = wt.get_config(name, **over)
    jp = wt.init_wavenet(jax.random.PRNGKey(0), jcfg)
    tp = pt.init_wavenet(pt.get_config(name, **over),
                         torch.Generator().manual_seed(0), "cpu")
    want = cases.flat(jax.tree.map(lambda s: np.asarray(tuple(s), object),
                                   jax_pspecs(jcfg, jp),
                                   is_leaf=lambda s: isinstance(s, tuple)))
    got = cases.flat(jax.tree.map(lambda s: np.asarray(s, object),
                                  sharding.param_pspecs(None, tp),
                                  is_leaf=lambda s: isinstance(s, tuple)))
    assert sorted(got) == sorted(want)
    for k in got:
        assert tuple(got[k]) == tuple(want[k]), k


@pytest.mark.parametrize("mesh", ["12", "22"])
def test_local_w_skip_blocks(runs, mesh):
    cfg = pt.get_config("tiny")
    got = cases.load(runs, f"step{mesh}")
    assert tuple(got["w_skip_local_shape"]) == (
        cfg.num_layers, cfg.dilation_channels, cfg.skip_channels // 2)


@pytest.mark.parametrize("mesh", MESHES)
def test_forward_equals_jax(runs, mesh):
    cfg = wt.get_config("tiny")
    x, _, _ = cases.batch(cases.config("tiny"))
    p = jax.tree.map(jnp.asarray, cases.params_of(cases.config("tiny")))
    want = np.asarray(wt.wavenet_logits(p, cfg, jnp.asarray(x)))
    got = cases.load(runs, f"step{mesh}")["logits"]
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", ["plain", "tk", "cond"])
@pytest.mark.parametrize("mesh", MESHES)
def test_train_step_equals_jax(runs, jax_steps, mesh, name):
    got = cases.load(runs, f"step{mesh}")
    loss, params = jax_steps[name]
    np.testing.assert_allclose(got[f"{name}/loss"], loss, **TOL)
    _tree_close(got, f"{name}/params/", params)


def _one_rank(tx, steps):
    cfg = cases.config("tiny")
    p = pt.from_jax_params(cases.params_of(cfg), "cpu")
    p = topt._map(lambda t: t.requires_grad_(True), p)
    x, y, _ = cases.batch(cfg)
    o = tx.init(p)
    for _ in range(steps):
        _, g = pt.train_step(p, o, cfg, tx, torch.from_numpy(x),
                             torch.from_numpy(y))
    return cases.flat(p), cases.flat(g)


@pytest.mark.parametrize("mesh", ["12", "22"])
def test_clip_sgd_and_grads_equal_one_rank(runs, mesh):
    """Under ``model = 2`` the global-norm clip and ``sgd_normalized`` take
    the logical leaves' norms and the gradients are one rank's."""
    got = cases.load(runs, f"step{mesh}")
    clipped, grads = _one_rank(topt.reference_adam(
        cases.LR, gradient_clipping=cases.CLIP), 1)
    norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                       for g in grads.values()))
    assert norm > 2 * cases.CLIP  # the clip acts
    _tree_close(got, "clip/params/", clipped)
    _tree_close(got, "grads/", grads)
    sgd, _ = _one_rank(topt.sgd_normalized(cases.SGD_LR, momentum=0.9), 2)
    _tree_close(got, "sgd/params/", sgd)


def test_sharded_pool_step_bitwise_equal_unsharded(runs):
    cfg = cases.config("tiny")
    params = pt.from_jax_params(cases.params_of(cfg), "cpu")
    _, temps, seeds, toffs = cases.pool_inputs(cfg)
    st = cases.pool_state(cfg, params)
    got = cases.load(runs, "pool41", 3)
    for i in range(2):
        _, cls, st = pt.generate_fast_batched(
            params, cfg, 0, cases.POOL_CHUNK, None, temperature=temps,
            state=st, lane_seed=seeds, lane_clock=toffs, return_state=True,
            device="cpu")
        np.testing.assert_array_equal(got[f"cls{i}"], cls.numpy())
        np.testing.assert_array_equal(got[f"ring{i}"], st.ring.numpy())
        np.testing.assert_array_equal(got[f"next{i}"], st.cls.numpy())
        assert int(got[f"t{i}"]) == st.t


def test_sharded_generation(runs):
    """``sharded_generate_fast`` is ``generate_fast`` on all streams at T =
    0 and 1 (the global call's uniforms); ``sharded_generate_fast_batched``
    equals the unsharded K4 plain version at T = 0 and, at T = 1, each
    block's call with the seed folded with its data index."""
    cfg = cases.config("tiny")
    params = pt.from_jax_params(cases.params_of(cfg), "cpu")
    prime = cases.pipe_prime(cfg, 4, seed=21)
    got = cases.load(runs, "generate21", 1)
    for T in (0.0, 1.0):
        _, c = pt.generate_fast(params, cfg, torch.Generator().manual_seed(6),
                                16, prime, temperature=T, device="cpu")
        np.testing.assert_array_equal(got[f"fast_T{T}"], c.numpy())
    _, c = pt.generate_fast_batched(params, cfg, 22, 16, prime,
                                    temperature=0.0, device="cpu")
    np.testing.assert_array_equal(got["batched_T0.0"], c.numpy())
    blocks = [pt.generate_fast_batched(
        params, cfg, pmesh.fold_seed(22, i), 16, prime[2 * i:2 * i + 2],
        temperature=1.0, device="cpu")[1].numpy() for i in range(2)]
    np.testing.assert_array_equal(got["batched_T1.0"], np.concatenate(blocks))
    assert "not divisible by data axis 2" in str(got["refused"])


def test_sharded_batch_iterator_puts_the_global_batch_back(runs):
    ds = pt.WaveNetDataset(dataset_file=os.path.join(runs, "ds.npz"),
                           item_length=64, target_length=8,
                           file_location=None, test_stride=50)
    ref = pt.BatchIterator(ds, 8, seed=3, skip_batches=1)
    got = cases.load(runs, "iterator21")
    for workers in (0, 2):
        for i, (x, y) in zip(range(3), ref):
            np.testing.assert_array_equal(got[f"w{workers}/x{i}"], x)
            np.testing.assert_array_equal(got[f"w{workers}/y{i}"], y)
        assert int(got[f"w{workers}/len"]) == len(ref)
        assert int(got[f"w{workers}/local"]) == 4
        ref = pt.BatchIterator(ds, 8, seed=3, skip_batches=1)
    for rank in (0, 1):
        np.testing.assert_array_equal(
            cases.load(runs, "iterator21", rank)["replicated"], [5.0] * 3)


def test_trivial_mesh_calls_no_collective():
    """Without a process group a 1 x 1 mesh runs the one-rank code: the
    step under it equals the step without a mesh bitwise."""
    cfg = cases.config("tiny")
    x, y, _ = cases.batch(cfg)
    trees = []
    for mesh in (None, pmesh.make_mesh(1, 1)):
        p = topt._map(lambda t: t.requires_grad_(True), pt.from_jax_params(
            cases.params_of(cfg), "cpu"))
        tx = topt.reference_adam(cases.LR, gradient_clipping=cases.CLIP)
        o = tx.init(p)
        pt.train_step(p, o, cfg, tx, torch.from_numpy(x),
                      torch.from_numpy(y), mesh=mesh)
        trees.append(cases.flat(p))
    for k in trees[0]:
        np.testing.assert_array_equal(trees[0][k], trees[1][k])


def test_multi_rank_entries_without_a_card_raise(tmp_path):
    """No fallback hides the device: without a card a rank asked for CUDA
    raises before any group forms, and so do the CLI and scaling_bench."""
    from pytorch_wavenet_tpu_torch.scripts import scaling_bench

    with pytest.raises(RuntimeError, match="cuda"):
        pmesh.init_distributed("cuda", init_method=f"file://{tmp_path}/s",
                               rank=0, world_size=2)
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="cuda"):
        scaling_bench.main(["--config", "tiny", "--max-ranks", "2"])
