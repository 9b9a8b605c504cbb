"""The t-halo exchange of the sharded hop: the counterpart of the JAX
package's ``_t_extend``, ``_project_face`` and ``_t_faces``
(``ops/dslash_pallas5.py:1059-1117``), on ``torch.distributed``
point-to-point messages instead of a ppermute.  No t-extended block is
built: the hop kernels read the two received planes where they lie.

Per hop a rank sends its first t-plane to rank − 1 (there it is the
t+1 face of the last row) and its last t-plane to rank + 1 (the t−1 face
of the first row), and receives the two planes it needs in return: one
``dist.batch_isend_irecv`` of two sends and two receives, tagged so that
a ring of two, where both messages go to the same peer, matches them.
On a ring of one nothing is sent: the faces are the rank's own edge
planes, the periodic wrap, as in the JAX package.  On NCCL the messages
run on NCCL's own stream, so a kernel launched before ``Exchange.wait``
overlaps with them (``ops.dslash_kernel.dslash_ch_overlap``).
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

    def __init__(self, face_m, face_p, works=(), sent=()):
        self.face_m, self.face_p = face_m, face_p
        # the send buffers stay referenced until the messages are out
        self._works, self._sent = list(works), sent

    def wait(self):
        for w in self._works:
            w.wait()
        self._works, self._sent = [], ()
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
    send_p, send_m = send_p.contiguous(), send_m.contiguous()
    recv_p, recv_m = torch.empty_like(send_p), torch.empty_like(send_m)
    g = mesh.group
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send_p, mesh.prev, g, _TAG_P),
        dist.P2POp(dist.isend, send_m, mesh.next, g, _TAG_M),
        dist.P2POp(dist.irecv, recv_p, mesh.next, g, _TAG_P),
        dist.P2POp(dist.irecv, recv_m, mesh.prev, g, _TAG_M)])
    return Exchange(recv_m, recv_p, works, (send_p, send_m))


def t_faces(psi_ch: torch.Tensor, mesh: TMesh, project: bool = False,
            dagger: bool = False):
    """(face_m, face_p) of ``psi_ch``, received: ``start_t_faces`` and
    its ``wait``."""
    return start_t_faces(psi_ch, mesh, project, dagger).wait()



def _wire(t: torch.Tensor) -> torch.Tensor:
    """A contiguous real view of a message (complex as its real pairs)."""
    t = t.contiguous()
    return torch.view_as_real(t) if t.is_complex() else t


def gather_t(f: torch.Tensor, mesh: TMesh, forward: bool) -> torch.Tensor:
    """The ring form of ``lattice.gather_neighbor`` for mu = t: f(x ± t̂)
    of a field with trailing [T_loc, Z, W] (any leading axes; a gauge
    link or a spinor).  The even-odd index w does not change under a t
    shift, so this is ``torch.roll`` along −3 with the plane that crosses
    the slab's edge taken from the neighbour: forward, each rank sends its
    first plane to rank − 1 and receives rank + 1's as its last row;
    backward, the last plane to rank + 1 and rank − 1's as its first.
    One send and one receive a rank (a ring of two pairs them with one
    peer); on a ring of one, the roll."""
    if mesh.nt == 1:
        return torch.roll(f, -1 if forward else 1, dims=-3)
    send = f[..., :1, :, :] if forward else f[..., -1:, :, :]
    wire = _wire(send)
    recv = torch.empty_like(wire)
    to, frm = (mesh.prev, mesh.next) if forward else (mesh.next, mesh.prev)
    for w in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, wire, to, mesh.group, _TAG_P),
            dist.P2POp(dist.irecv, recv, frm, mesh.group, _TAG_P)]):
        w.wait()
    plane = torch.view_as_complex(recv) if send.is_complex() else recv
    if forward:
        return torch.cat([f[..., 1:, :, :], plane], dim=-3)
    return torch.cat([plane, f[..., :-1, :, :]], dim=-3)
