"""A process group, this rank's device and the wire between them.

Port of ``genie_tpu/parallel/mesh.py``. The JAX package names two mesh axes:
``batch`` (data parallelism over training and inference windows) and ``src``
(the product graph partitioned by source-grid nodes, its source-axis
aggregation riding the halo exchange of :mod:`.product_shard`). Here one
``torch.distributed`` process group plays either axis: one process per rank,
each with its own device, and explicit collectives in place of a sharded
``jit``.

The wire is what a collective moves. An ``nccl`` group moves device tensors.
A ``gloo`` group moves host tensors: its point-to-point operations are
built for them, so a CUDA tensor is staged through pinned host memory on
the way out and copied back to the device on arrival. That staging is the
declared wire of a gloo group (``Mesh.wire == "host"``), chosen from
``dist.get_backend(group)`` and reported by :meth:`Mesh.describe`; on CPU
tensors it costs nothing. Several ranks on one card need gloo (NCCL refuses
two ranks on one GPU); ranks on their own cards take NCCL (``torchrun
--nproc-per-node N``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from genie_tpu_torch.device import resolve_device

# backend -> where collectives move tensors
WIRES = {"nccl": "device", "gloo": "host"}


@dataclass(frozen=True)
class Mesh:
    """One process group seen from one rank."""

    group: object           # torch.distributed ProcessGroup
    rank: int               # this process's rank in ``group``
    size: int               # ranks in ``group``
    ranks: tuple            # global rank of each group rank
    device: torch.device    # this rank's device
    backend: str            # "nccl" or "gloo"
    wire: str               # "device" (nccl) or "host" (gloo: pinned staging)

    def describe(self) -> str:
        return (f"rank {self.rank}/{self.size} on {self.device}, backend "
                f"{self.backend}, wire {self.wire}"
                + (" (pinned host staging)" if self.wire == "host"
                   and self.device.type == "cuda" else ""))


def make_mesh(group=None, device=None) -> Mesh:
    """The :class:`Mesh` of ``group`` (the default group when None) for
    this process, whose tensors live on ``device`` (the card by default,
    see :func:`~genie_tpu_torch.device.resolve_device`). The process group
    must be initialised; ``torch.distributed.init_process_group`` takes the
    address, world size and rank from its caller."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised")
    group = dist.group.WORLD if group is None else group
    backend = str(dist.get_backend(group))
    if backend not in WIRES:
        raise ValueError(f"make_mesh: backend {backend!r} is not one of {sorted(WIRES)}")
    device = resolve_device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"make_mesh: an nccl group needs CUDA devices, got {device}")
    return Mesh(group=group, rank=dist.get_rank(group),
                size=dist.get_world_size(group),
                ranks=tuple(dist.get_process_group_ranks(group)),
                device=device, backend=backend, wire=WIRES[backend])


# -- collectives over the wire -------------------------------------------------

def _to_wire(t, mesh: Mesh):
    t = t.contiguous()
    if mesh.wire == "host" and t.device.type != "cpu":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t)
    return t


def _empty_wire(shape, dtype, mesh: Mesh):
    if mesh.wire == "host" and mesh.device.type != "cpu":
        return torch.empty(shape, dtype=dtype, pin_memory=True)
    return torch.empty(shape, dtype=dtype, device=mesh.device)


def all_reduce_(t, mesh: Mesh):
    """Sum ``t`` over the group, in place; returns ``t``."""
    w = _to_wire(t, mesh)
    dist.all_reduce(w, group=mesh.group)
    if w is not t:
        t.copy_(w)
    return t


def broadcast_(t, mesh: Mesh):
    """Overwrite ``t`` with group rank 0's, in place; returns ``t``."""
    w = _to_wire(t, mesh)
    dist.broadcast(w, src=mesh.ranks[0], group=mesh.group)
    if w is not t:
        t.copy_(w)
    return t


def all_gather_cat(t, mesh: Mesh, dim: int = 0):
    """Every rank's ``t`` (one shape on all ranks), concatenated in rank
    order along ``dim``, on every rank."""
    w = _to_wire(t, mesh)
    out = [_empty_wire(w.shape, w.dtype, mesh) for _ in range(mesh.size)]
    dist.all_gather(out, w, group=mesh.group)
    return torch.cat([o.to(t.device) for o in out], dim=dim)


def exchange(send, mesh: Mesh, dst: int, src: int):
    """Send ``send`` to group rank ``dst`` while receiving a tensor of the
    same shape and type from group rank ``src`` (one round of
    ``batch_isend_irecv``); returns it on ``send``'s device."""
    w = _to_wire(send, mesh)
    recv = _empty_wire(w.shape, w.dtype, mesh)
    ops = [dist.P2POp(dist.isend, w, mesh.ranks[dst], group=mesh.group),
           dist.P2POp(dist.irecv, recv, mesh.ranks[src], group=mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(send.device)


# -- placing trees ---------------------------------------------------------------

def _tree_map(fn, tree):
    if isinstance(tree, (torch.Tensor, np.ndarray, np.generic)):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


def shard_leading_axis(tree, mesh: Mesh):
    """Every tensor, numpy array or numpy scalar of ``tree`` on this rank's
    device: this rank's block of rows where its leading axis divides by the
    group size
    (the window axis), the whole of it otherwise (scalars and mismatched
    arrays are replicated, as the JAX ``shard_leading_axis`` places them).
    Other leaves are returned as they are."""
    n, r = mesh.size, mesh.rank

    def put(x):
        x = torch.as_tensor(x).to(mesh.device)
        if x.dim() >= 1 and x.shape[0] % n == 0:
            m = x.shape[0] // n
            return x[r * m:(r + 1) * m]
        return x

    return _tree_map(put, tree)


def replicate(obj, mesh: Mesh):
    """Rank 0's copy on every rank. A module is moved to this rank's device
    and its parameters and buffers are overwritten in place with rank 0's;
    in a tree every tensor is copied to the device and broadcast."""
    if isinstance(obj, nn.Module):
        obj.to(mesh.device)
        with torch.no_grad():
            for t in (*obj.parameters(), *obj.buffers()):
                broadcast_(t.data, mesh)
        return obj
    return _tree_map(
        lambda x: broadcast_(torch.as_tensor(x).to(mesh.device, copy=True), mesh), obj)
