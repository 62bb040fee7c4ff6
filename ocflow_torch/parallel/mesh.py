"""The data mesh (port of ``ocflow_tpu/parallel/mesh.py``): one process per
rank over one ``'data'`` axis, and the collectives the port's data
parallelism needs.

A ``Mesh`` is this rank's view of the process group: its rank, the world
size and its device. The global batch of ``B`` samples is split into
contiguous blocks: rank ``r`` takes ``[r B / N, (r + 1) B / N)``, as the
JAX package's ``NamedSharding(mesh, P('data'))`` places a batch over the
devices of one host. Parameters are replicated (``replicated`` broadcasts
rank 0's), and the training step sums its gradients over the ranks.

Under gloo, ``all_reduce`` and ``broadcast`` take CUDA tensors as they are;
``all_gather`` and point-to-point exchanges of CUDA tensors go through the
host, where gloo carries them.

Global-batch statistics (the JAX package's BatchNorm and feature moments
under ``jit`` on global arrays): :meth:`Mesh.psum` is the differentiable
sum over the ranks, and :func:`synced_stats` hands a mesh to every module of
a model that takes one (``sync_mesh``: the port's ``BatchNorm`` and
``FlowNetCV``'s feature normalization) for the length of a step.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.distributed as dist
from torch import nn

from ocflow_torch.parallel.distributed import local_device, world_size


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D ``('data',)`` mesh. Made by
    :func:`make_mesh` once the process group runs; a mesh built by hand
    (``Mesh(rank, size)``) splits batches but cannot communicate."""

    rank: int
    size: int
    device: torch.device = torch.device("cpu")
    axis_names: tuple = ("data",)

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.size,)

    def _staged(self, t: torch.Tensor) -> bool:
        """Whether ``t`` goes through the host for gloo."""
        return t.is_cuda and dist.get_backend() == "gloo"

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns it. Every rank ends
        with the same bits (each element is reduced once, then copied)."""
        if self.size > 1:
            dist.all_reduce(t)
        return t

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """A detached copy of ``t`` summed over the ranks."""
        return self.all_reduce(t.detach().clone())

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, differentiable (``jax.lax.psum``):
        the backward sums the cotangent over the ranks, so that each rank's
        input receives the gradient of the global loss, whose shares the
        ranks hold. One collective each way."""
        return _PSum.apply(t, self)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated on dim 0, rank order."""
        if self.size == 1:
            return t
        src = t.detach().contiguous()
        if self._staged(src):
            return self.all_gather(src.cpu()).to(t.device)
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src)
        return torch.cat(parts, 0)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place; returns it."""
        if self.size > 1:
            dist.broadcast(t, src)
        return t

    def exchange(self, to_prev: torch.Tensor, to_next: torch.Tensor):
        """Send ``to_prev`` to rank - 1 and ``to_next`` to rank + 1;
        returns ``(from_prev, from_next)``: what rank - 1 sent as its
        ``to_next`` and rank + 1 as its ``to_prev``, zeros at the ends of
        the axis (no wrap-around)."""
        from_prev, from_next = torch.zeros_like(to_next), torch.zeros_like(to_prev)
        if self.size == 1:
            return from_prev, from_next
        staged = self._staged(to_prev)
        bufs = [t.detach().cpu() if staged else t.detach().contiguous()
                for t in (to_prev, to_next, from_prev, from_next)]
        ops = []
        if self.rank > 0:
            ops += [dist.P2POp(dist.isend, bufs[0], self.rank - 1),
                    dist.P2POp(dist.irecv, bufs[2], self.rank - 1)]
        if self.rank < self.size - 1:
            ops += [dist.P2POp(dist.isend, bufs[1], self.rank + 1),
                    dist.P2POp(dist.irecv, bufs[3], self.rank + 1)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if staged:
            return bufs[2].to(to_next.device), bufs[3].to(to_prev.device)
        return bufs[2], bufs[3]


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce(t.detach().contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad.contiguous().clone()), None


@contextlib.contextmanager
def synced_stats(module: nn.Module, mesh: "Mesh | None"):
    """Inside, every sub-module of ``module`` with a ``sync_mesh`` attribute
    (``models.common.BatchNorm``, ``models.pwc_net.FlowNetCV``) takes its
    batch statistics over the global batch of ``mesh`` (each one given back
    on exit): a train-mode BatchNorm normalizes by the global mean and
    variance and updates its running statistics with them, and FlowNetCV's
    eager forward normalizes its features by the global batch's moments,
    in either mode. A step runs its forward and its backward inside, so the
    backward's collectives (``Mesh.psum``) and a remat recompute's see the
    mesh too. Nothing is set for ``mesh`` None or a mesh of one: the
    single-process path, bit for bit.

    Every rank must issue the same collectives in the same order, or gloo
    pairs the wrong ones (or waits forever). The ranks run the same model
    on blocks of the same shape, so their forwards issue the same sequence;
    autograd's engine runs a graph's backward nodes in an order fixed by
    the graph (a ready node of higher sequence number first), and a
    non-reentrant ``torch.utils.checkpoint`` recomputes its segment when
    the backward first unpacks one of its saved tensors, a node of that
    same order, stopping after the same op on every rank: equal graphs,
    equal sequences of collectives."""
    if mesh is None or mesh.size == 1:
        yield
        return
    mods = [m for m in module.modules() if hasattr(m, "sync_mesh")]
    saved = [m.sync_mesh for m in mods]
    for m in mods:
        m.sync_mesh = mesh
    try:
        yield
    finally:
        for m, v in zip(mods, saved):
            m.sync_mesh = v


def make_mesh(axis_shapes: Sequence[int] | None = None,
              axis_names: Sequence[str] = ("data",), device=None) -> Mesh:
    """This rank's mesh over every process of the group (one process: a
    mesh of one). ``axis_shapes`` defaults to ``(world size,)``; a shape of
    more than one axis, or whose product is not the world size, raises.
    ``device``: this rank's device (default :func:`local_device`)."""
    world = world_size()
    shape = (world,) if axis_shapes is None else tuple(int(s) for s in axis_shapes)
    if len(shape) != 1 or len(tuple(axis_names)) != 1:
        raise ValueError(f"make_mesh: the port has one data axis; got shape {shape}, "
                         f"names {tuple(axis_names)}")
    if math.prod(shape) != world:
        raise ValueError(f"make_mesh: shape {shape} over a world of {world} processes")
    rank = dist.get_rank() if dist.is_initialized() else 0
    return Mesh(rank, world, local_device(device), tuple(axis_names))


def default_mesh(axis_shapes: Sequence[int] | None = None, device=None) -> Mesh | None:
    """``make_mesh(axis_shapes)`` when more than one process runs, else
    None (one process trains alone whatever ``axis_shapes`` says, as the
    JAX loop builds its mesh only over several devices)."""
    if world_size() == 1:
        return None
    return make_mesh(axis_shapes, device=device)


def batch_sharding(mesh: Mesh, batch_size: int) -> slice:
    """Rank ``mesh.rank``'s block of a global batch of ``batch_size``."""
    if batch_size % mesh.size:
        raise ValueError(f"a batch of {batch_size} does not split over {mesh.size} ranks")
    n = batch_size // mesh.size
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def shard_batch(batch, mesh: Mesh):
    """This rank's contiguous block of a ``[B, ...]`` tensor or of a dict
    of them (``B`` must divide by the world size)."""
    if isinstance(batch, torch.Tensor):
        return batch[batch_sharding(mesh, batch.shape[0])]
    sizes = {v.shape[0] for v in batch.values()}
    if len(sizes) != 1:
        raise ValueError(f"shard_batch: entries of different batch sizes {sizes}")
    block = batch_sharding(mesh, sizes.pop())
    return {k: v[block] for k, v in batch.items()}


def _tensors(module: nn.Module) -> list[torch.Tensor]:
    """The parameters and buffers of ``module``, or of each module of a
    sequence (a GAN run's generator and discriminator)."""
    modules = module if isinstance(module, (list, tuple)) else (module,)
    return [t for m in modules for t in (*m.parameters(), *m.buffers())]


def replicated(module, mesh: Mesh):
    """Rank 0's parameters and buffers broadcast into ``module`` (or into
    each module of a sequence) on every rank, in place; returns it."""
    if mesh.size > 1:
        with torch.no_grad():
            for t in _tensors(module):
                mesh.broadcast(t.data)
    return module


def check_replicated(module, mesh: Mesh) -> None:
    """Raise unless every rank's parameters and buffers (of ``module``, or
    of each module of a sequence) equal rank 0's bit for bit (rank 0's
    flattened copy broadcast and compared on each rank)."""
    if mesh.size == 1:
        return
    tensors = [t.detach().reshape(-1) for t in _tensors(module) if t.is_floating_point()]
    flat = torch.cat([t.double() for t in tensors])
    ref = mesh.broadcast(flat.clone())
    bad = torch.tensor([float(not torch.equal(flat, ref))], device=flat.device)
    if mesh.all_reduce(bad).item():
        raise RuntimeError("the ranks' parameters differ: the replicas diverged")
