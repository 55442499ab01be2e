"""The port's reference-API shims and utilities against the JAX package:
``dilate``, ``constant_pad_1d`` and ``DilatedQueue`` (the cases of
``tests/test_modules.py``, each output compared with the JAX function's),
``param_summary`` text, ``make_dot`` source, and the package's exports.

Tolerance: none. The shims only move and pad values, so every output is
compared bitwise; ``constant_pad_1d``'s gradient too (a crop of the
upstream gradient); the summaries are compared as text."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_wavenet_tpu as wt
import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu.ops import dilated as jdil
from pytorch_wavenet_tpu.ops import queues as jq
from pytorch_wavenet_tpu.utils import visualize as jvis
from pytorch_wavenet_tpu_torch.ops import dilated as tdil
from pytorch_wavenet_tpu_torch.ops import queues as tq
from pytorch_wavenet_tpu_torch.utils import visualize as tvis


def _same(t, j):
    np.testing.assert_array_equal(t.detach().numpy(), np.asarray(j))
    assert tuple(t.shape) == tuple(j.shape)


# (input shape, dilation, init_dilation): tests/test_modules.py's cases
DILATE_CASES = [
    ((1, 1, 12), 2, 1), ((2, 1, 6), 4, 2), ((4, 1, 3), 1, 4),
    ((1, 1, 10), 4, 1), ((4, 1, 3), 1, 4),
    ((2, 3, 4), 4, 2), ((2, 3, 4), 2, 2), ((3, 2, 7), 3, 1),
]


@pytest.mark.parametrize("shape,dilation,init", DILATE_CASES)
@pytest.mark.parametrize("pad_start", [True, False])
def test_dilate_equals_jax(shape, dilation, init, pad_start):
    x = np.random.default_rng(sum(shape)).normal(size=shape).astype(
        np.float32)
    got = tdil.dilate(torch.from_numpy(x), dilation, init, pad_start)
    _same(got, jdil.dilate(jnp.asarray(x), dilation, init, pad_start))


def test_dilate_reference_cases():
    """tests/test_modules.py's assertions on the port: the 1 -> 2 -> 4 -> 1
    round trip, padding at the start, the no-op fast path."""
    x = torch.arange(1, 13, dtype=torch.float32).reshape(1, 1, 12)
    d2 = pt.dilate(x, 2)
    assert d2.shape == (2, 1, 6)
    assert d2[0, 0].tolist() == [1, 3, 5, 7, 9, 11]
    d4 = pt.dilate(d2, 4, init_dilation=2)
    assert d4[3, 0].tolist() == [4, 8, 12]
    assert pt.dilate(d4, 1, init_dilation=4)[0, 0].tolist() == list(
        range(1, 13))
    x = torch.arange(1, 11, dtype=torch.float32).reshape(1, 1, 10)
    flat = pt.dilate(pt.dilate(x, 4), 1, init_dilation=4)[0, 0]
    assert flat[:2].tolist() == [0, 0] and flat[2:].tolist() == list(
        range(1, 11))
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    assert pt.dilate(x, 2, init_dilation=2) is x


@pytest.mark.parametrize("shape,target,dim,value,pad_start", [
    ((2, 3), 5, 1, 7.0, True), ((2, 3), 5, 1, 0.0, False),
    ((4, 2, 3), 6, 0, -1.5, False), ((4, 2, 3), 5, -2, 2.0, True),
    ((3,), 3, 0, 1.0, True), ((1, 6), 10, 1, 0.0, True),
])
def test_constant_pad_forward_and_backward_equal_jax(shape, target, dim,
                                                     value, pad_start):
    x = np.random.default_rng(len(shape)).normal(size=shape).astype(
        np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tdil.constant_pad_1d(xt, target, dim, value, pad_start)
    want = jdil.constant_pad_1d(jnp.asarray(x), target, dim, value, pad_start)
    _same(got, want)
    w = np.arange(np.prod(want.shape), dtype=np.float32).reshape(want.shape)
    (gt,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), xt)
    gj = jax.grad(lambda a: jnp.sum(jdil.constant_pad_1d(
        a, target, dim, value, pad_start) * w))(jnp.asarray(x))
    _same(gt, gj)  # the gradient crops back to the input's region


def test_constant_pad_refuses_to_shrink():
    with pytest.raises(ValueError):
        pt.constant_pad_1d(torch.ones(3), 2)
    with pytest.raises(ValueError):
        jdil.constant_pad_1d(jnp.ones((3,)), 2)


def _script():
    """20 calls: enqueues past the wrap, strided dequeues with wrap-around,
    a reset in the middle."""
    rng = np.random.default_rng(7)
    calls = []
    for i in range(20):
        if i == 11:
            calls.append(("reset",))
        elif i % 3 == 2:
            calls.append(("dequeue", int(rng.integers(1, 4)),
                          int(rng.integers(1, 4))))
        else:
            calls.append(("enqueue", rng.normal(size=2).astype(np.float32)))
    return calls


def test_dilated_queue_sequence_equals_jax():
    qt = tq.DilatedQueue.create(max_length=6, num_channels=2, dilation=2,
                                num_deq=3)
    qj = jq.DilatedQueue.create(max_length=6, num_channels=2, dilation=2,
                                num_deq=3)
    assert (qt.max_length, qt.num_channels) == (6, 2)
    dequeued = 0
    for call in _script():
        before = qt.data.clone()
        if call[0] == "enqueue":
            nt = qt.enqueue(torch.from_numpy(call[1]))
            qj = qj.enqueue(jnp.asarray(call[1]))
        elif call[0] == "dequeue":
            tt, nt = qt.dequeue(call[1], call[2])
            tj, qj = qj.dequeue(call[1], call[2])
            _same(tt, tj)
            dequeued += 1
        else:
            nt, qj = qt.reset(), qj.reset()
        assert torch.equal(qt.data, before)  # the old queue is untouched
        qt = nt
        _same(qt.data, qj.data)
        assert (qt.in_pos, qt.out_pos, qt.dilation, qt.num_deq) == (
            qj.in_pos, qj.out_pos, qj.dilation, qj.num_deq)
    assert dequeued >= 5


def test_dilated_queue_reference_invariant():
    """The reference's interleaved invariant (tests/test_modules.py): after
    i enqueues the first of 8 dilation-1 taps is max(i - 7, 0)."""
    q = pt.DilatedQueue.create(max_length=8, num_channels=1)
    for i in range(20):
        q = q.enqueue(torch.tensor([float(i + 1)]))
        t, q = q.dequeue(num_deq=8, dilation=1)
        assert float(t[0][0]) == max(i + 1 - 7, 0)


@pytest.mark.parametrize("name", ["tiny", "vocoder", "student"])
def test_param_summary_equals_jax(name):
    """The port's tree (dicts, the student's tuple of flows) summarized by
    both functions, the JAX one on the same weights as numpy leaves."""
    g = torch.Generator().manual_seed(0)
    if name == "student":
        scfg = pt.IAFConfig(flows=2, layers=3, residual_channels=8,
                            dilation_channels=8, skip_channels=8,
                            end_channels=8, cond_channels=4)
        tp = pt.init_student(scfg, g, device="cpu")
        assert isinstance(tp["flows"], tuple)
    else:
        tp = pt.init_wavenet(pt.get_config(name), g, "cpu")
    jp = jax.tree_util.tree_map(lambda t: t.numpy(), tp)
    text = tvis.param_summary(tp)
    assert text == jvis.param_summary(jp)
    count = sum(t.numel() for t in jax.tree_util.tree_leaves(tp))
    assert text.splitlines()[-1].split()[-1] == f"{count:,}"


_NODE = re.compile(r'^  (v\d+|e\d+|trunc) \[(label="[^"]*"(, )?)?'
                   r'(fillcolor="\w+")?\];$')
_EDGE = re.compile(r"^  (v\d+|e\d+) -> (v\d+|e\d+);$")


def _parse(dot):
    lines = dot.splitlines()
    assert lines[0] == "digraph aten {" and lines[-1] == "}"
    assert lines[1].startswith("  node [shape=box")
    nodes, edges, colors = set(), [], {}
    for line in lines[2:-1]:
        m = _NODE.match(line)
        if m:
            nodes.add(m.group(1))
            c = re.search(r'fillcolor="(\w+)"', line)
            if c:
                colors[m.group(1)] = c.group(1)
            continue
        m = _EDGE.match(line)
        assert m, f"not a dot statement: {line!r}"
        edges.append(m.groups())
    for a, b in edges:
        assert a in nodes and b in nodes, (a, b)
    return nodes, edges, colors


def test_make_dot_of_wavenet_logits():
    cfg = pt.get_config("tiny")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.classes, (2, cfg.item_length)))

    def fn(p, x):
        return pt.wavenet_logits(p, cfg, x, cfg.output_length)

    dot = tvis.make_dot(fn, params, x)
    nodes, edges, colors = _parse(dot)
    n_in = sum(len(v) for v in params.values()) + 1
    assert sum(c == "palegreen" for c in colors.values()) == n_in
    assert "lightsalmon" in colors.values() and "trunc" not in nodes
    assert '[label="mm"]' in dot and "f32[2,4,32]" in dot  # the logits
    ops = sum(n.startswith("e") for n in nodes)
    short = tvis.make_dot(fn, params, x, max_nodes=10)
    s_nodes, _, _ = _parse(short)
    assert sum(n.startswith("e") for n in s_nodes) == 10
    assert f'trunc [label="... {ops - 10} more ops"]' in short


def test_the_jax_packages_new_exports():
    """The five names the JAX ``__init__`` exports that the port lacked."""
    for name in ("list_all_audio_files", "ema_params", "dilate",
                 "constant_pad_1d", "DilatedQueue"):
        assert hasattr(wt, name) and name in pt.__all__
        assert getattr(pt, name) is not None
    assert pt.DilatedQueue is tq.DilatedQueue and pt.dilate is tdil.dilate
