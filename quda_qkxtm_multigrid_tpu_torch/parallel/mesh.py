"""The ring of ranks along t, and the t-slabs of fields on it.

The counterpart of the JAX package's ``parallel/mesh.py`` for the fused
sharded path, on ``torch.distributed``: ``TMesh`` is a ring of ``nt``
ranks, one process each, rank r holding the t-slab [r·T_loc, (r+1)·T_loc)
of every field (T_loc = T / nt).  The process group runs on NCCL for
cards and on gloo for the CPU; even a ring of one rank on a card has its
NCCL group, so the reductions take the path of a multi-card run.

Only t is split: the fused kernels keep the z, x and y hops inside a
rank (the JAX package's shard_map path shards t only; its z/w splits ran
on XLA's auto-partitioned path, which has no counterpart here), so a
z or w split raises.  T_loc must be even: the slab's origin is then
even and the checkerboard phase of every local site is the global one.

The caller starts the processes (``torchrun --nproc-per-node N``, or
its own spawn) and either initialises the default process group itself
and calls ``make_lattice_mesh``, or calls ``init_ring``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry


@dataclasses.dataclass(frozen=True)
class TMesh:
    """A ring of ``nt`` ranks along t; this process is ``rank``, its
    fields live on ``device``.  ``group`` is the process group (None: the
    default group)."""

    nt: int
    rank: int
    device: torch.device
    group: Optional[object] = None

    @property
    def prev(self) -> int:
        """The rank of the t−1 neighbour slab."""
        return (self.rank - 1) % self.nt

    @property
    def next(self) -> int:
        """The rank of the t+1 neighbour slab."""
        return (self.rank + 1) % self.nt

    def allreduce(self, value: torch.Tensor) -> torch.Tensor:
        """The sum over the ring of a tensor of any shape (a new tensor).
        A complex one is summed as its real pairs: the reductions of the
        collective libraries are not relied on for complex types."""
        v = value.detach().clone()
        if v.is_complex():
            pairs = torch.view_as_real(v).contiguous()
            dist.all_reduce(pairs, op=dist.ReduceOp.SUM, group=self.group)
            return torch.view_as_complex(pairs)
        v = v.reshape(-1)
        dist.all_reduce(v, op=dist.ReduceOp.SUM, group=self.group)
        return v.reshape(value.shape)

    def allmax(self, value: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over the ring of a real tensor (a new
        tensor; ``value`` itself on a ring of one)."""
        if self.nt == 1:
            return value
        v = value.detach().clone()
        dist.all_reduce(v, op=dist.ReduceOp.MAX, group=self.group)
        return v

    def allgather_t(self, x: torch.Tensor, axis: int = -3) -> torch.Tensor:
        """Every rank's ``x`` joined along its t axis ``axis`` in rank
        order (the same on every rank): the whole lattice's field from
        the slabs, or the coarse residual [2, nvec, Tc, Zc, Yc, Xc] of
        the replicated coarse solve (``axis=2``).  ``x`` itself on a ring
        of one (no copy).  ``TMesh.gathers`` counts the calls."""
        TMesh.gathers += 1
        if self.nt == 1:
            return x
        v = x.contiguous()
        if v.is_complex():
            v = torch.view_as_real(v)
        parts = [torch.empty_like(v) for _ in range(self.nt)]
        dist.all_gather(parts, v, group=self.group)
        if x.is_complex():
            parts = [torch.view_as_complex(p) for p in parts]
        return torch.cat(parts, dim=axis)

    def t_range(self, t_extent: int) -> tuple:
        """(first, count) of this rank's rows of a t axis of the whole
        lattice's extent ``t_extent`` (a fine T or a coarse Tc)."""
        if t_extent % self.nt:
            raise ValueError(f"t extent {t_extent} is not divisible by "
                             f"nt={self.nt}")
        n = t_extent // self.nt
        return self.rank * n, n


TMesh.gathers = 0   # calls of allgather_t, for the benchmarks' records


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def make_lattice_mesh(grid: Sequence[int] = (1, 1, 1), device="cuda",
                      group=None) -> TMesh:
    """The ring of grid = (Gt, Gz, Gw) = (nt, 1, 1) over the initialised
    process group ``group`` (None: the default one), whose size must be
    nt: NCCL for a card ``device``, gloo for the CPU.  Any z or w split
    raises."""
    grid = tuple(int(g) for g in grid)
    if len(grid) != 3 or min(grid) < 1:
        raise ValueError(f"grid {grid} is not (Gt, Gz, Gw)")
    if grid[1] != 1 or grid[2] != 1:
        raise ValueError(f"grid {grid}: the sharded path splits t only "
                         "(Gz = Gw = 1)")
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: start the "
                           "ranks with torchrun or call init_ring")
    device = torch.device(device)
    backend = dist.get_backend(group)
    if backend != _backend(device):
        raise ValueError(f"a {device.type} ring needs the "
                         f"{_backend(device)} backend, not {backend}")
    size = dist.get_world_size(group)
    if size != grid[0]:
        raise ValueError(f"grid {grid} needs {grid[0]} ranks, the group "
                         f"has {size}")
    return TMesh(nt=grid[0], rank=dist.get_rank(group), device=device,
                 group=group)


def init_ring(nt: int, rank: int, init_method: str,
              device="cuda") -> TMesh:
    """Initialise the default process group of ``nt`` ranks (``init_method``
    e.g. "tcp://localhost:<port>" or "file://<path>"; NCCL on a card,
    gloo on the CPU) and return its ring.  A card ``device`` with an index
    becomes this process's current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    dist.init_process_group(_backend(device), init_method=init_method,
                            world_size=nt, rank=rank)
    return make_lattice_mesh((nt, 1, 1), device)


def local_t(T: int, mesh: TMesh) -> int:
    """T_loc of a lattice of extent ``T`` on ``mesh``; raises unless nt
    divides T into even slabs."""
    if T % mesh.nt:
        raise ValueError(f"T={T} is not divisible by nt={mesh.nt}")
    t_loc = T // mesh.nt
    if t_loc % 2:
        raise ValueError(f"local T extent {t_loc} must be even (the "
                         "slab's origin must be even)")
    return t_loc


def local_geometry(geom: Geometry, mesh: TMesh) -> Geometry:
    """The geometry of this rank's slab of a lattice ``geom``."""
    return Geometry(geom.X, geom.Y, geom.Z, local_t(geom.T, mesh))


def t_slab(field: torch.Tensor, mesh: TMesh) -> torch.Tensor:
    """This rank's t-slab of a canonical field (t is axis −3), on the
    mesh's device.  The whole field on a ring of one (no copy)."""
    t_loc = local_t(field.shape[-3], mesh)
    slab = field.narrow(-3, mesh.rank * t_loc, t_loc).contiguous()
    return slab.to(mesh.device)


def shard_spinor(psi: torch.Tensor, mesh: TMesh) -> torch.Tensor:
    """This rank's slab of a spinor [..., 2, 4, 3, T, Z, W]."""
    return t_slab(psi, mesh)


def shard_gauge(u: torch.Tensor, mesh: TMesh) -> torch.Tensor:
    """This rank's slab of a gauge field [4, 2, 3, 3, T, Z, W]."""
    return t_slab(u, mesh)
