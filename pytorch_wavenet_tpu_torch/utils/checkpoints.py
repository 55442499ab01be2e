"""Checkpoints in the JAX package's ``pytorch_wavenet_tpu/1`` format.

A checkpoint is one msgpack blob (flax's encoding) holding the config
JSON, the params, the optimizer state and the step, written atomically
(tmp + rename) to ``{directory}/{name}_{step:010d}.ckpt``. Either package
reads what the other writes. The codec is the port's own
(``utils/msgpack_lite.py``): the machine with the card has no ``msgpack``.

``opt_state`` is the optimizer state in optax's state-dict layout
(``training/optimizers.py::ReferenceAdam.state_dict``), nil when there is
none; a loaded blob hands it back as nested numpy, which the JAX package
reads with ``load_checkpoint(path, opt_state_template=tx.init(params))``
and the port's optimizer with ``load_state_dict``.

Sharded checkpoints (the JAX package's ``pytorch_wavenet_tpu/sharded/1``)
are a directory ``{name}_{step:010d}.ckpt.sharded/`` holding
``manifest.msgpack`` (step, config, extra, ``process_count`` and the
params/opt_state skeleton, each array leaf a ``{shape, dtype}``
placeholder) and one ``shards_p{k}.msgpack`` per process (flat ``{leaf
path: [{index, data}, ...]}``, ``index`` the block's ``[[start, stop],
...]`` in the global array). :func:`save_checkpoint_sharded` writes one
rank's file (rank 0 also the manifest) from its local blocks; either
package's reader assembles full arrays (:func:`load_checkpoint_sharded`);
:func:`latest_checkpoint` ranks complete directories beside files.

:class:`AsyncCheckpointer` keeps the copy to the host, the encoding and the
write off the training thread (the JAX package's ``AsyncCheckpointer``).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import os
import time

import numpy as np
import torch

from ..config import WaveNetConfig
from ..device import resolve_device
from ..models.convert import from_jax_params, to_numpy_params
from .msgpack_lite import packb, unpackb

CKPT_SUFFIX = ".ckpt"
SHARDED_SUFFIX = ".ckpt.sharded"
FORMAT = "pytorch_wavenet_tpu/1"
SHARDED_FORMAT = "pytorch_wavenet_tpu/sharded/1"
_LEAF_KEY = "__sharded_array__"


def checkpoint_path(directory: str, name: str, step: int) -> str:
    return os.path.join(directory, f"{name}_{step:010d}{CKPT_SUFFIX}")


def sharded_checkpoint_path(directory: str, name: str, step: int) -> str:
    return os.path.join(directory, f"{name}_{step:010d}{SHARDED_SUFFIX}")


def save_checkpoint(directory: str, name: str, step: int, params,
                    cfg: WaveNetConfig | None = None,
                    extra: dict | None = None, opt_state=None) -> str:
    """Write the params (torch tensors or numpy arrays, nested dicts) with
    ``cfg``, ``step`` and ``opt_state`` (optax's state-dict layout, nested
    dicts of tensors or numpy, or None); returns the path."""
    path = checkpoint_path(directory, name, step)
    os.makedirs(directory, exist_ok=True)
    blob = {
        "format": FORMAT,
        "time": time.time(),
        "step": int(step),
        "config": cfg.to_json() if cfg is not None else None,
        "params": to_numpy_params(params),
        "opt_state": (to_numpy_params(opt_state) if opt_state is not None
                      else None),
        "extra": extra or {},
    }
    _write_atomic(path, packb(blob))
    return path


def _write_atomic(path: str, data: bytes) -> None:
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def save_checkpoint_sharded(directory: str, name: str, step: int, params,
                            opt_state=None, cfg: WaveNetConfig | None = None,
                            extra: dict | None = None, mesh=None) -> str:
    """Write this rank's shard file of a sharded checkpoint (rank 0 also
    the manifest); call it on every rank of ``mesh``. ``params`` are the
    rank's blocks (``parallel.sharding.shard_params``), ``opt_state`` the
    optimizer state of those blocks in optax's state-dict layout (or
    None). A block's global index follows from the partition specs and the
    rank's coordinates; the blocks of data index 0 are written (a
    replicated leaf by rank 0 alone), so each element is written once. No
    collective is called, so it can run on a worker thread. Returns the
    directory."""
    import torch.distributed as dist

    from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_index, axis_size
    from ..parallel.sharding import param_pspecs, state_specs

    path = sharded_checkpoint_path(directory, name, step)
    os.makedirs(path, exist_ok=True)
    m = axis_size(mesh, MODEL_AXIS)
    world = axis_size(mesh, DATA_AXIS) * m
    rank = dist.get_rank() if world > 1 else 0
    owner = axis_index(mesh, DATA_AXIS) == 0
    mi = axis_index(mesh, MODEL_AXIS)
    shards: dict = {}

    def walk(tree, spec, key):
        """The skeleton of ``tree``, this rank's owned blocks into
        ``shards``."""
        if isinstance(tree, dict):
            return {k: walk(v, spec[k], f"{key}/{k}")
                    for k, v in tree.items()}
        if tree is None:
            return None
        arr = np.asarray(tree)
        shape, index = list(arr.shape), [[0, n] for n in arr.shape]
        sharded = MODEL_AXIS in spec
        if sharded:
            d = spec.index(MODEL_AXIS)
            shape[d] = arr.shape[d] * m
            index[d] = [mi * arr.shape[d], (mi + 1) * arr.shape[d]]
        if (owner if sharded else rank == 0):  # each element once
            shards[key] = [{"index": index, "data": arr}]
        return {_LEAF_KEY: [shape, str(arr.dtype)]}

    params_np = to_numpy_params(params)
    opt_np = to_numpy_params(opt_state)
    skel = {"params": walk(params_np, param_pspecs(cfg, params), "params"),
            "opt_state": walk(opt_np, state_specs(opt_np, params),
                              "opt_state")}
    _write_atomic(os.path.join(path, f"shards_p{rank}.msgpack"),
                  packb({"process": rank, "shards": shards}))
    if rank == 0:
        _write_atomic(os.path.join(path, "manifest.msgpack"), packb({
            "format": SHARDED_FORMAT,
            "time": time.time(),
            "step": int(step),
            "config": cfg.to_json() if cfg is not None else None,
            "process_count": world,
            "params": skel["params"],
            "opt_state": skel["opt_state"],
            "extra": extra or {},
        }))
    return path


def _read_msgpack(path: str):
    with open(path, "rb") as f:
        return unpackb(f.read())


def _sharded_files(path: str) -> tuple[dict | None, list[str] | None]:
    """(manifest, shard file list) if the sharded checkpoint at ``path`` is
    complete, else (manifest or None, None)."""
    mpath = os.path.join(path, "manifest.msgpack")
    if not os.path.isfile(mpath):
        return None, None
    manifest = _read_msgpack(mpath)
    files = [os.path.join(path, f"shards_p{k}.msgpack")
             for k in range(int(manifest["process_count"]))]
    if not all(os.path.isfile(f) for f in files):
        return manifest, None
    return manifest, files


def _assemble(skel, flat: dict):
    """The manifest's skeleton with every placeholder replaced by the
    array its shard entries make up; raises unless the entries cover every
    element."""
    if skel is None:
        return None

    def walk(node, prefix):
        if isinstance(node, dict) and set(node) == {_LEAF_KEY}:
            shape, dtype = node[_LEAF_KEY]
            shape = tuple(int(s) for s in shape)
            key = prefix[:-1]
            # the codec widens bfloat16 to float32 (utils/msgpack_lite.py)
            arr = np.empty(shape, np.float32 if dtype == "bfloat16"
                           else np.dtype(dtype))
            covered = np.zeros(shape, dtype=bool)
            for e in flat.get(key, []):
                sl = tuple(slice(int(a), int(b)) for a, b in e["index"])
                arr[sl] = np.asarray(e["data"]).reshape(arr[sl].shape)
                covered[sl] = True
            if not covered.all():
                raise ValueError(
                    f"sharded checkpoint is missing data for {key!r} "
                    f"({int(covered.sum())}/{covered.size} elements "
                    f"covered)")
            return arr
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in node.items()}
        return node

    return walk(skel, "")


def load_checkpoint_sharded(path: str) -> dict:
    """Assemble a sharded checkpoint directory into full host arrays: a
    dict with ``step``, ``config``, ``params`` and ``opt_state`` (nested
    numpy, optax's state-dict layout, or None) and ``extra``. Raises
    ``FileNotFoundError`` without a manifest or with a shard file
    missing."""
    manifest, files = _sharded_files(path)
    if manifest is None:
        raise FileNotFoundError(f"no manifest under {path}")
    if files is None:
        raise FileNotFoundError(
            f"sharded checkpoint {path} is incomplete (expects "
            f"{manifest['process_count']} shard files)")
    flat: dict[str, list] = {}
    for f in files:
        for key, entries in _read_msgpack(f)["shards"].items():
            # msgpack may restore the entry list as a dict of str indices
            if isinstance(entries, dict):
                entries = [entries[k] for k in sorted(entries, key=int)]
            flat.setdefault(key, []).extend(entries)

    def tree(root):
        n = len(root) + 1
        return _assemble(manifest[root], {
            k[n:]: v for k, v in flat.items() if k.startswith(root + "/")})

    return {
        "step": int(manifest["step"]),
        "config": (WaveNetConfig.from_json(manifest["config"])
                   if manifest["config"] else None),
        "params": tree("params"),
        "opt_state": tree("opt_state"),
        "extra": manifest.get("extra", {}),
    }


def load_checkpoint(path: str, device: str | torch.device = "cuda") -> dict:
    """Read a checkpoint file, or a sharded checkpoint directory: a dict
    with ``step``, ``config`` (WaveNetConfig or None), ``params`` (torch
    tensors on ``device``), ``opt_state`` (nested numpy or None) and
    ``extra``."""
    dev = resolve_device(device)
    if os.path.isdir(path):
        blob = load_checkpoint_sharded(path)
    else:
        blob = _read_msgpack(path)
        blob["config"] = (WaveNetConfig.from_json(blob["config"])
                          if blob["config"] else None)
    return {
        "step": int(blob["step"]),
        "config": blob["config"],
        "params": from_jax_params(blob["params"], dev),
        "opt_state": blob.get("opt_state"),
        "extra": blob.get("extra", {}),
    }


def latest_checkpoint(location: str) -> str | None:
    """Newest checkpoint in ``location`` by (step, mtime): ``.ckpt`` files
    and complete ``.ckpt.sharded`` directories alike (a directory still
    missing a shard file is never picked); None when there is none."""
    if not os.path.isdir(location):
        return None
    files = []
    for f in os.listdir(location):
        p = os.path.join(location, f)
        if f.endswith(SHARDED_SUFFIX) and os.path.isdir(p):
            if _sharded_files(p)[1] is not None:
                files.append((p, f[: -len(SHARDED_SUFFIX)]))
        elif f.endswith(CKPT_SUFFIX) and os.path.isfile(p):
            files.append((p, f[: -len(CKPT_SUFFIX)]))
    if not files:
        return None

    def key(entry):
        p, stem = entry
        try:
            step = int(stem.rsplit("_", 1)[-1])
        except ValueError:
            step = -1
        return (step, os.path.getmtime(p))

    return max(files, key=key)[0]


def load_latest_model_from(location: str,
                           device: str | torch.device = "cuda",
                           verbose: bool = True) -> dict:
    """Load the newest checkpoint in ``location``."""
    path = latest_checkpoint(location)
    if path is None:
        raise FileNotFoundError(f"no checkpoints under {location}")
    if verbose:
        print("load model " + path)
    return load_checkpoint(path, device)


def _clone(tree):
    """A copy of a nested dict whose tensors are cloned where they lie (on
    the card: a device-to-device copy queued on the current stream)."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return tree


class AsyncCheckpointer:
    """One worker thread writes checkpoints; one save is in flight at a time
    (a newer save first waits for the previous one: bounded memory, ordered
    files).

    The port's train step updates the params and the optimizer state in
    place, so :meth:`save` first clones both on the device, on the caller's
    stream, and records a CUDA event after the clones: that copy plays the
    part of the JAX package's copy against buffer donation. The worker
    waits on the event, then copies the clones to the host on a stream of
    its own (so the copy does not queue behind the next steps' kernels),
    turns the optimizer state into optax's layout with ``state_dict`` and
    writes the file atomically. The file holds the values from the moment
    of the save, whatever steps run meanwhile.

    With a ``mesh`` of more than one rank (the trainer's mesh mode) each
    rank's worker writes the rank's blocks with
    :func:`save_checkpoint_sharded` (which calls no collective), as the JAX
    package routes a tree that no process holds whole."""

    def __init__(self, mesh=None):
        from ..parallel.mesh import mesh_shape

        self._ex = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt")
        self._pending: concurrent.futures.Future | None = None
        self._stream = None  # the worker's copy stream on the card
        self.mesh = mesh
        self.sharded = int(np.prod(list(mesh_shape(mesh).values()))) > 1

    def save(self, directory: str, name: str, step: int, params,
             opt_state=None, cfg: WaveNetConfig | None = None,
             extra: dict | None = None, state_dict=None
             ) -> concurrent.futures.Future:
        """Queue a checkpoint of ``params`` and ``opt_state`` as they are
        now. ``state_dict``: turns the (cloned) optimizer state into optax's
        layout on the worker (an optimizer's ``state_dict``); without it
        ``opt_state`` is written as given. Returns the future of the path
        (also its ``path`` attribute, known at once)."""
        self.wait()
        params_c, opt_c = _clone(params), _clone(opt_state)
        dev = next((t.device for t in _tensors(params_c)), None)
        event = None
        if dev is not None and dev.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))

        def write():
            ctx = contextlib.nullcontext()
            if event is not None:
                event.synchronize()
                if self._stream is None:
                    self._stream = torch.cuda.Stream(dev)
                ctx = torch.cuda.stream(self._stream)
            with ctx:
                opt = (state_dict(opt_c) if state_dict and opt_c is not None
                       else opt_c)
                if self.sharded:
                    return save_checkpoint_sharded(
                        directory, name, step, params_c, opt_state=opt,
                        cfg=cfg, extra=extra, mesh=self.mesh)
                return save_checkpoint(directory, name, step, params_c,
                                       cfg=cfg, extra=extra, opt_state=opt)

        self._pending = self._ex.submit(write)
        self._pending.path = (sharded_checkpoint_path if self.sharded
                              else checkpoint_path)(directory, name, step)
        return self._pending

    def wait(self) -> str | None:
        """Block until the in-flight save (if any) is on disk; returns its
        path (and raises what the worker raised)."""
        if self._pending is None:
            return None
        fut, self._pending = self._pending, None
        return fut.result()

    def close(self):
        self.wait()
        self._ex.shutdown(wait=True)


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree
