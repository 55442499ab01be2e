"""Device meshes and the collectives of the port's multi-device layer.

The JAX package drives every device from one process and lets GSPMD place
the collectives. Here one rank is one process and one device, and every
collective is explicit and goes through one of the helpers below. Axes,
as in the JAX package's ``parallel/mesh.py``:

* ``data``: batch and generation-stream parallelism (gradient all-reduce,
  stream sharding);
* ``model``: channel parallelism of the wide skip and end projections.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with dims
``("data", "model")`` over the initialised process group (rank ``d *
model + m`` at coordinate ``(d, m)``); :func:`single_device_mesh` is the
trivial ``1 x 1`` mesh, which needs no process group and on which no
helper calls a collective, so single-process code runs unchanged.

:func:`init_distributed` forms the process group from torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) or from explicit
arguments, and picks the backend by one rule, which it prints: ``nccl``
when every rank of the host has a card of its own, ``gloo`` on the CPU or
when ranks share a card (NCCL refuses two ranks on one device). Gloo moves
host memory: under gloo a CUDA tensor is staged through a host copy
(:func:`_staged`, the transport; the computation stays on the card).

Not ported, by design: the JAX package's ``named`` (a ``NamedSharding``
factory): a rank keeps only its local block, so there is no global array
to place.
"""

from __future__ import annotations

import contextlib
import os
from datetime import timedelta
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


class TrivialMesh:
    """The mesh of one process: every axis has size 1 and index 0, and no
    collective is ever called on it."""

    def __init__(self, names: tuple = (DATA_AXIS, MODEL_AXIS)):
        self.mesh_dim_names = tuple(names)

    def __repr__(self) -> str:
        return f"TrivialMesh({self.mesh_dim_names})"


def init_distributed(device: str | torch.device = "cuda",
                     init_method: str | None = None, rank: int | None = None,
                     world_size: int | None = None,
                     local_rank: int | None = None, verbose: bool = True,
                     timeout: float | None = None):
    """Form the default process group (once per process) and return this
    rank's device: ``cuda:{local_rank % device_count}``, or the CPU for
    ``device="cpu"``. A CUDA device without a card raises.

    ``rank``, ``world_size`` and ``local_rank`` default to torchrun's
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``; ``init_method`` to
    ``env://`` (torchrun's ``MASTER_ADDR``/``MASTER_PORT``); tests pass a
    ``file://`` store. The backend is ``nccl`` when the host's ranks
    (``LOCAL_WORLD_SIZE``, else the world size) each have a card, else
    ``gloo``; rank 0 prints it. ``timeout``: the group's timeout in
    seconds (torch's default when None). Any failure to form the group
    raises."""
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    world_size = (int(env.get("WORLD_SIZE", 1)) if world_size is None
                  else int(world_size))
    local_rank = (int(env.get("LOCAL_RANK", rank)) if local_rank is None
                  else int(local_rank))
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks exists; "
                f"{world_size} were asked for")
        return dev
    local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
    own_cards = (dev.type == "cuda"
                 and local_world <= torch.cuda.device_count())
    backend = "nccl" if own_cards else "gloo"
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world_size,
        timeout=None if timeout is None else timedelta(seconds=timeout))
    if verbose and rank == 0:
        why = ("every rank has a card of its own" if own_cards else
               "ranks on the CPU" if dev.type == "cpu" else
               f"{local_world} ranks share {torch.cuda.device_count()} "
               "card(s)")
        print(f"torch.distributed: {world_size} ranks, backend {backend} "
              f"({why})", flush=True)
    return dev


def make_mesh(data: int | None = None, model: int = 1, devices=None):
    """A ``(data, model)`` mesh over the process group. With no ``data``
    every rank not on the model axis goes to the data axis; raises when
    ``data x model`` is not the world size (or when a mesh of more than
    one rank is asked for without a process group). ``devices``: the
    device type the ``DeviceMesh`` is named for (one rank is one device;
    default ``cuda`` under NCCL, else ``cpu``: under gloo the mesh only
    names the groups, and tensors stay where they are)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} ranks")
    if data * model == 1:
        return single_device_mesh()
    from torch.distributed.device_mesh import DeviceMesh

    dtype = devices or ("cuda" if dist.get_backend() == "nccl" else "cpu")
    return DeviceMesh(dtype, torch.arange(world).reshape(data, model),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def single_device_mesh() -> TrivialMesh:
    return TrivialMesh()


def fold_seed(seed: int, index: int) -> int:
    """A seed in [0, 2**31) mixed from ``seed`` and ``index`` (murmur3's
    finaliser over both): the port's counterpart of folding a data index
    or a stream group into a JAX key."""
    x = ((int(seed) * 0x9E3779B9) ^ (int(index) * 0x85EBCA6B)) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    x ^= x >> 16
    return x & 0x7FFFFFFF


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` (1 without a mesh or on the trivial mesh)."""
    if mesh is None or isinstance(mesh, TrivialMesh):
        return 1
    return int(mesh.mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis``."""
    if axis_size(mesh, axis) == 1:
        return 0
    return int(mesh.get_local_rank(axis))


def mesh_shape(mesh) -> dict:
    """``{axis: size}``, as the JAX package's ``mesh.shape``."""
    names = (DATA_AXIS, MODEL_AXIS) if mesh is None else mesh.mesh_dim_names
    return {a: axis_size(mesh, a) for a in names}


def axis_ranks(mesh, axis: str) -> list[int]:
    """The global ranks of this rank's group along ``axis``, in axis
    order."""
    if axis_size(mesh, axis) == 1:
        return [dist.get_rank() if dist.is_initialized() else 0]
    t = mesh.mesh
    dim = mesh.mesh_dim_names.index(axis)
    coord = list(mesh.get_coordinate())
    idx = [slice(None) if i == dim else coord[i] for i in range(t.dim())]
    return [int(r) for r in t[tuple(idx)].reshape(-1)]


@contextlib.contextmanager
def _staged(x: torch.Tensor):
    """The tensor a collective should move: ``x`` itself, or, under gloo,
    a host copy of a CUDA tensor. Yields ``(buf, done)``; call ``done()``
    after the collective to copy a staged result back into ``x``."""
    if x.is_cuda and dist.get_backend() == "gloo":
        buf = x.detach().to("cpu", copy=True)
        yield buf, lambda: x.copy_(buf)
    else:
        yield x, lambda: None


def all_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over this rank's group along ``axis`` (a new
    tensor; ``x`` itself on an axis of size 1). Every rank gets the same
    values."""
    if axis_size(mesh, axis) == 1:
        return x
    out = x.detach().clone()
    with _staged(out) as (buf, done):
        dist.all_reduce(buf, group=mesh.get_group(axis))
        done()
    return out


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0
               ) -> torch.Tensor:
    """The blocks of ``x`` of every rank along ``axis``, concatenated
    along ``dim`` in axis order (every block must have ``x``'s shape)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    x = x.detach().contiguous()
    with _staged(x) as (buf, _):
        parts = [torch.empty_like(buf) for _ in range(n)]
        dist.all_gather(parts, buf, group=mesh.get_group(axis))
    return torch.cat(parts, dim=dim).to(x.device)


def broadcast(x: torch.Tensor, src: int) -> torch.Tensor:
    """``x`` of global rank ``src`` on every rank, in place; returns
    ``x``. Without a process group, ``x``."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return x
    with _staged(x) as (buf, done):
        dist.broadcast(buf, src)
        done()
    return x


class Sent(NamedTuple):
    """A send in flight: ``wait()`` before dropping it (it holds the sent
    buffer)."""

    work: object
    buf: torch.Tensor

    def wait(self) -> None:
        self.work.wait()


def send(x: torch.Tensor, peer: int, tag: int = 0) -> Sent:
    """Start sending a copy of ``x`` to global rank ``peer``."""
    buf = x.detach().to("cpu", copy=True) if (
        x.is_cuda and dist.get_backend() == "gloo") else x.detach().clone()
    return Sent(dist.isend(buf, peer, tag=tag), buf)


def recv(shape, dtype, device, peer: int, tag: int = 0) -> torch.Tensor:
    """Receive a tensor of ``shape`` and ``dtype`` from global rank
    ``peer`` onto ``device`` (blocks until it arrives)."""
    dev = torch.device(device)
    host = dev.type == "cuda" and dist.get_backend() == "gloo"
    buf = torch.empty(shape, dtype=dtype, device="cpu" if host else dev)
    dist.recv(buf, peer, tag=tag)
    return buf.to(dev)
