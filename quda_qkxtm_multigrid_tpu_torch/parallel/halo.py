"""The halo exchange of the sharded hop: the counterpart of the JAX
package's ``_t_extend``, ``_project_face`` and ``_t_faces``
(``ops/dslash_pallas5.py:1059-1117``), on ``torch.distributed``
point-to-point messages instead of a ppermute.  No extended block is
built: the hop kernels read the received planes where they lie.

On a t-ring (the grid (nt, 1, 1)):

Per hop a rank sends its first t-plane to rank − 1 (there it is the
t+1 face of the last row) and its last t-plane to rank + 1 (the t−1 face
of the first row), and receives the two planes it needs in return: one
``dist.batch_isend_irecv`` of two sends and two receives, tagged so that
a ring of two, where both messages go to the same peer, matches them.
On a ring of one nothing is sent: the faces are the rank's own edge
planes, the periodic wrap, as in the JAX package.  On NCCL the messages
run on NCCL's own stream, so a kernel launched before ``Exchange.wait``
overlaps with them (``ops.dslash_kernel.dslash_ch_overlap``).

On a box (a z or y split, ``box_faces``) the z planes and the y
rows of the split axes travel beside the t planes, in one batch whose
order is fixed (``_TAGS``).  ``shift`` is the mesh form of a neighbour
gather along any split axis.  A staged mesh (card fields over gloo)
copies every message through the host.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import _proj_rank2
from quda_qkxtm_multigrid_tpu_torch.parallel.mesh import TMesh

_TAG_P, _TAG_M = 0, 1   # the t+1 face (a first plane), the t−1 face


def project_face(plane: torch.Tensor, plus: bool) -> torch.Tensor:
    """Spin-project a 24-channel t-plane [1, 24, Z, W] to the 12-channel
    2-spinor of 1 ± γ4 (channel (s*3+c)*2 + ri, s ∈ {0, 1}): the upper
    rows of the projection the receiving hop applies, done before the
    send so a message carries half the bytes (the reference's
    spin-projected ghost pack).  In this basis row s of 1 ± γ4 is
    ψ_s ± ψ_{s+2}, so it is one add, and gives the numbers of the JAX
    package's ``_project_face`` and of the kernel's own projection."""
    upper, _ = _proj_rank2(3, plus)
    sign = upper[0][1][1].real
    if any(row != [(s, 1), (s + 2, sign)] for s, row in enumerate(upper)):
        raise AssertionError(f"1{'+' if plus else '-'}gamma_4 is not "
                             f"psi_s +- psi_(s+2): {upper}")
    spins = plane.unflatten(1, (4, 6))
    return torch.add(spins[:, :2], spins[:, 2:], alpha=sign).flatten(1, 2)


class Exchange:
    """The faces of one hop in flight: ``face_m`` (the t−1 plane of row
    0) and ``face_p`` (the t+1 plane of row T_loc−1) are the receive
    buffers; ``wait`` returns them once they have arrived (on NCCL: once
    the current stream waits for them)."""

    def __init__(self, face_m, face_p, works=(), sent=(), mesh=None):
        self.face_m, self.face_p = face_m, face_p
        # the send buffers stay referenced until the messages are out
        self._works, self._sent = list(works), sent
        self._mesh = mesh

    def wait(self):
        for w in self._works:
            w.wait()
        self._works, self._sent = [], ()
        if self._mesh is not None and self._mesh.staged:
            self.face_m = self._mesh.from_wire(self.face_m)
            self.face_p = self._mesh.from_wire(self.face_p)
            self._mesh = None
        return self.face_m, self.face_p


def start_t_faces(psi_ch: torch.Tensor, mesh: TMesh, project: bool = False,
                  dagger: bool = False) -> Exchange:
    """Start the exchange of the t-faces of a channel field
    [T_loc, C, Z, W].  ``project`` spin-projects them before sending:
    the t+1 face with the projector of the forward t hop (``plus =
    dagger``), the t−1 face with the backward one (``plus = not
    dagger``)."""
    send_p, send_m = psi_ch[:1], psi_ch[-1:]
    if project:
        send_p = project_face(send_p, plus=dagger)
        send_m = project_face(send_m, plus=not dagger)
    if mesh.nt == 1:
        return Exchange(send_m.contiguous(), send_p.contiguous())
    send_p, send_m = mesh.to_wire(send_p), mesh.to_wire(send_m)
    recv_p, recv_m = torch.empty_like(send_p), torch.empty_like(send_m)
    g = mesh.group
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send_p, mesh.prev, g, _TAG_P),
        dist.P2POp(dist.isend, send_m, mesh.next, g, _TAG_M),
        dist.P2POp(dist.irecv, recv_p, mesh.next, g, _TAG_P),
        dist.P2POp(dist.irecv, recv_m, mesh.prev, g, _TAG_M)])
    return Exchange(recv_m, recv_p, works, (send_p, send_m), mesh)


def t_faces(psi_ch: torch.Tensor, mesh: TMesh, project: bool = False,
            dagger: bool = False):
    """(face_m, face_p) of ``psi_ch``, received: ``start_t_faces`` and
    its ``wait``."""
    return start_t_faces(psi_ch, mesh, project, dagger).wait()


# ---- the box: z and w faces beside the t faces -----------------------

# The tags of the box exchange, (the receiver's minus face, its plus
# face) for each grid axis.  NCCL ignores tags and pairs a peer's
# messages by the order they are issued in; every rank issues them in
# one order, t, then z, then w, minus before plus, so the pairs match on
# tags and on order alike (a grid axis of 2 has one peer both ways).
_TAGS = {0: (1, 0), 1: (3, 2), 2: (5, 4)}


def _ends(f: torch.Tensor, axis: int, xh: int):
    """(the first, the last) plane of a field with trailing [T, C, Z, W]
    along grid axis ``axis``: a t plane [1, C, Z, W], a z plane
    [T, C, 1, W], or a y row [T, C, Z, Xh] of the merged axis."""
    if axis == 0:
        return f[:1], f[-1:]
    if axis == 1:
        return f[:, :, :1], f[:, :, -1:]
    return f[..., :xh], f[..., -xh:]


def box_faces(psi_ch: torch.Tensor, mesh: TMesh, xh: int):
    """Every face that the hop of a box reads, received: (face_m, face_p,
    zw_faces), the t planes [1, 24, Z, W] (a rank's own edge planes where
    Gt = 1, the periodic wrap) and ``zw_faces`` = (z−1, z+1, y−1, y+1),
    the z planes [T, 24, 1, W] and the y rows [T, 24, Z, Xh] of the split
    axes (None for an axis the grid does not split).  A rank sends its
    last plane to the next rank of the axis (there it is the minus face)
    and its first to the previous one, and receives the two it reads, in
    one ``dist.batch_isend_irecv`` issued in the order of ``_TAGS``."""
    ops, faces = [], {}
    g = mesh.group
    for axis in (0, 1, 2):
        first, last = _ends(psi_ch, axis, xh)
        if mesh.grid[axis] == 1:
            if axis == 0:
                faces[0] = (last.contiguous(), first.contiguous())
            continue
        prev, nxt = mesh.neighbours(axis)
        send_m, send_p = mesh.to_wire(last), mesh.to_wire(first)
        recv_m, recv_p = torch.empty_like(send_m), torch.empty_like(send_p)
        tag_m, tag_p = _TAGS[axis]
        ops += [dist.P2POp(dist.isend, send_m, nxt, g, tag_m),
                dist.P2POp(dist.isend, send_p, prev, g, tag_p),
                dist.P2POp(dist.irecv, recv_m, prev, g, tag_m),
                dist.P2POp(dist.irecv, recv_p, nxt, g, tag_p)]
        faces[axis] = (recv_m, recv_p)
    for w in (dist.batch_isend_irecv(ops) if ops else []):
        w.wait()
    faces = {a: tuple(mesh.from_wire(f) for f in pair)
             for a, pair in faces.items()}
    zw = faces.get(1, (None, None)) + faces.get(2, (None, None))
    return faces[0][0], faces[0][1], zw


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A contiguous real view of a message (complex as its real pairs)."""
    t = t.contiguous()
    return torch.view_as_real(t) if t.is_complex() else t


def shift(f: torch.Tensor, mesh: TMesh, axis: int, forward: bool,
          xh: int = 1) -> torch.Tensor:
    """The mesh form of ``lattice.gather_neighbor`` along grid axis
    ``axis`` (0 t, 1 z, 2 y): f(x ± μ̂) of a field with trailing
    [T_loc, Z_loc, W_loc] (any leading axes; a gauge link or a spinor).
    A t, z or y shift does not change the checkerboard index k, so this
    is ``torch.roll`` along −3, −2, or −1 by ``xh`` (a y row of the
    merged axis), with the plane or row that crosses the box's edge
    taken from the neighbour: forward, each rank sends its first to the
    previous rank of the axis and receives the next rank's as its last;
    backward, its last to the next rank and the previous rank's as its
    first.  One send and one receive a rank (an axis of two pairs them
    with one peer); on an axis of one, the roll."""
    dim, width = {0: (-3, 1), 1: (-2, 1), 2: (-1, xh)}[axis]
    if mesh.grid[axis] == 1:
        return torch.roll(f, -width if forward else width, dims=dim)
    n = f.shape[dim]
    send = f.narrow(dim, 0 if forward else n - width, width)
    wire = mesh.to_wire(_wire(send))
    recv = torch.empty_like(wire)
    prev, nxt = mesh.neighbours(axis)
    to, frm = (prev, nxt) if forward else (nxt, prev)
    for w in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, wire, to, mesh.group, _TAG_P),
            dist.P2POp(dist.irecv, recv, frm, mesh.group, _TAG_P)]):
        w.wait()
    recv = mesh.from_wire(recv)
    plane = torch.view_as_complex(recv) if send.is_complex() else recv
    if forward:
        return torch.cat([f.narrow(dim, width, n - width), plane], dim=dim)
    return torch.cat([plane, f.narrow(dim, 0, n - width)], dim=dim)


def gather_t(f: torch.Tensor, mesh: TMesh, forward: bool) -> torch.Tensor:
    """The mesh form of ``lattice.gather_neighbor`` for mu = t
    (``shift`` along t)."""
    return shift(f, mesh, 0, forward)


def gather_z(f: torch.Tensor, mesh: TMesh, forward: bool) -> torch.Tensor:
    """The mesh form of ``lattice.gather_neighbor`` for mu = z
    (``shift`` along z)."""
    return shift(f, mesh, 1, forward)


def gather_w(f: torch.Tensor, mesh: TMesh, forward: bool,
             xh: int) -> torch.Tensor:
    """The mesh form of ``lattice.gather_neighbor`` for mu = y: a roll by
    a y row (``xh`` entries) of the merged axis, the row that crosses
    the box's edge from the neighbour (``shift`` along y)."""
    return shift(f, mesh, 2, forward, xh)

