// Fused Wilson hop on the planar-channel layout (CUDA C++ for sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel K1,
// quda_qkxtm_multigrid_tpu/ops/dslash_pallas5.py::_plane_body (reached
// through dslash_ch_pallas5 / dslash_ch_pallas5_slab / dslash_ch_auto).
// Its plane, slab and Z-block grids are TPU VMEM tilings of one
// computation; this kernel replaces all three.
//
// What it computes, for every site x of the output parity:
//   D psi(x) = sum_mu (1 -+ g_mu) U_mu(x) psi(x+mu) + (1 +- g_mu) U_mu^dag(x-mu) psi(x-mu)
// (dagger swaps the projectors), then the epilogues, in order:
//   twist b(1 + i a g5)  or  chiral 6x6 clover A (fwd) / A^dag (dag),
//   xpay  x + c*(...),
//   optional second output: A^dag of the result (post = 1) or
//   b'(1 + i a' g5) of the result (post = 2).
//
// Layout: every operand is [T, C, Z, W] real (channel c = a*2 + re/im):
// psi, x, out, out2 C = 24 (spin-colour kk = s*3+c); gauge C = 96
// (recon-12: rows 0,1 of the doubled links, row 2 = conj(r0 x r1)
// rebuilt in registers) or 144; clover C = 144, channel
// ((h*6+r)*6+c)*2+ri.  The doubled gauge holds U_mu(x) (fb = 0) and
// U_mu(x-mu) (fb = 1) at the output site x, so no link is gathered.
//
// Bound: device-memory bytes.  Per output site it needs 8 links x 12
// reals + psi in + psi out, i.e. 1320 flop per >= 576 B in float
// recon-12, far below the H100's ~20 flop/B balance point.  One thread
// per output site (t, z, w); neighbouring threads take neighbouring w, so
// every channel load and store is coalesced.  This first version relies
// on L2 for the reuse of each psi value by its 8 neighbours; the channel
// layout keeps each neighbour read a contiguous run of w.

// Host side: a plain C interface for ctypes (no PyTorch headers, so
// nvcc builds it in seconds).  Every pointer is a device pointer, or null
// where the epilogue is off; the stream is PyTorch's current stream.  The
// launch neither synchronises nor allocates: the caller owns every
// buffer.  Returns cudaGetLastError() after the launch (0 on success).
// The device code and the launcher are in dslash_ch.cuh; the bf16
// operand tier of this kernel is dslash_ch_bf16.cu, its bf16 spinor
// storage dslash_ch_bf16s.cu and its recon-8 gauge dslash_ch_r8.cu.

#include "dslash_ch.cuh"

extern "C" int qkx_dslash_ch_f32(const void* psi, const void* g,
                                 const void* cinv, const void* x, void* out,
                                 void* out2, int T, int Z, int W, int Xh,
                                 int parity, int dagger, int recon12,
                                 int twist, double ta, double tb, int clover,
                                 int xpay, double xc, int post, double pa,
                                 double pb, void* stream) {
  return qkx::launch_dslash<float, float, float, float, float, float>(
      psi, g, cinv, x, out, out2, T, Z, W, Xh, parity, dagger, recon12,
      twist, ta, tb, clover, xpay, xc, post, pa, pb, stream);
}

extern "C" int qkx_dslash_ch_f64(const void* psi, const void* g,
                                 const void* cinv, const void* x, void* out,
                                 void* out2, int T, int Z, int W, int Xh,
                                 int parity, int dagger, int recon12,
                                 int twist, double ta, double tb, int clover,
                                 int xpay, double xc, int post, double pa,
                                 double pb, void* stream) {
  return qkx::launch_dslash<double, double, double, double, double,
                                 double>(
      psi, g, cinv, x, out, out2, T, Z, W, Xh, parity, dagger, recon12,
      twist, ta, tb, clover, xpay, xc, post, pa, pb, stream);
}
