// The t-local fused Wilson hop K4 on a box of a (Gt, Gz, Gw) process grid
// (CUDA C++ for sm_90a): the hop of a rank whose box is split in z or y
// as well as in t.
//
// Replaces the JAX package's Pallas TPU kernel
// quda_qkxtm_multigrid_tpu/ops/dslash_pallas5.py:
//   K4  dslash_ch_pallas5_local (pallas_call :768), K1 on a t-extended
//       local block, which the JAX package runs on t-slabs only: its z
//       and w splits run the hop through XLA's auto-partitioned rolls
//       (dirac.py:330-345).  Here the box's hop is this kernel, with the
//       z and y faces read where they lie beside the t faces.
//
// What it computes: K4's hop and epilogues (dslash_ch_local.cu: twist or
// chiral clover A / A^dag, then xpay), from the same device function
// dslash_site with TMODE 2 (t faces face_m / face_p, 24 channels) and
// ZW: z does not wrap where the z faces are given (planes z = -1 and
// Z_loc: [T_loc, 24, 1, W_loc] of the z-1 / z+1 neighbours, channel
// stride W_loc), y does not wrap where the y faces are given (rows
// y = -1 and Y_loc: [T_loc, 24, Z_loc, Xh] of the y-1 / y+1 neighbours,
// channel stride Z_loc * Xh, read at the site's k).  x is never split.
// Every local extent is even, so the box's origin is even and the local
// checkerboard phase is the global one.
//
// Three instances, recon-12 only, as K4's (each built for dagger or not,
// periodic or APBC, and the split patterns z, y and z + y):
//   qkx_dslash_ch_box_f32      float everything: the sharded matpc chain;
//   qkx_dslash_ch_box_f64      double, bare hop: the sharded full
//                              operator (m, prepare, reconstruct);
//   qkx_dslash_ch_box_f32_g16  bf16 gauge and clover inverse, float psi,
//                              x, out and faces: the bf16 operand tier.
//
// Bound: device-memory bytes, as K4 (576 B a site for the float bare hop:
// gauge 384, psi 96, out 96), plus the faces of the split axes, 96 B a
// face site: 96 * (2/T_loc + 2/Z_loc + 2/Y_loc) B a site with every axis
// split.  One thread per output site, neighbouring threads on
// neighbouring w.  The exchange itself is outside the kernel
// (parallel/halo.py).
//
// The antiperiodic t boundary: bit kAntiperiodicT of parity, and t_first
// / t_last, the local rows of global rows 0 and T-1 (dslash_ch.cuh).
//
// Host side: a plain C interface for ctypes (no PyTorch headers).  Every
// pointer is a device pointer, or null where the epilogue or an axis's
// faces are off; the stream is PyTorch's current stream.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue without launching (launch_dslash_box says when).

#include "dslash_ch.cuh"

using bf16 = __nv_bfloat16;

#define QKX_BOX_ENTRY(NAME, R, G, C, S)                                       \
  extern "C" int NAME(                                                        \
      const void* psi, const void* g, const void* cinv, const void* x,        \
      void* out, const void* face_m, const void* face_p,                      \
      const void* face_zm, const void* face_zp, const void* face_wm,          \
      const void* face_wp, int T, int Z, int W, int Xh, int parity,           \
      int t_first, int t_last, int dagger, int recon12, int twist,            \
      double ta, double tb, int clover, int xpay, double xc, void* stream) {  \
    return qkx::launch_dslash_box<R, G, C, S, S, S>(                          \
        psi, g, cinv, x, out, face_m, face_p, face_zm, face_zp, face_wm,      \
        face_wp, T, Z, W, Xh, parity, t_first, t_last, dagger, recon12,       \
        twist, ta, tb, clover, xpay, xc, stream);                             \
  }

QKX_BOX_ENTRY(qkx_dslash_ch_box_f32, float, float, float, float)
QKX_BOX_ENTRY(qkx_dslash_ch_box_f64, double, double, double, double)
QKX_BOX_ENTRY(qkx_dslash_ch_box_f32_g16, float, bf16, bf16, float)
