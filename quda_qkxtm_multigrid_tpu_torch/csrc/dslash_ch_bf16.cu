// The bf16 operand tier of the fused Wilson hop (CUDA C++ for sm_90a):
// kernels K1d and K2d.
//
// Replaces the JAX package's Pallas TPU kernels with bf16=True,
// quda_qkxtm_multigrid_tpu/ops/dslash_pallas5.py: dslash_ch_pallas5 /
// dslash_ch_pallas5_slab (K1d; the in-kernel upcast _kernel_v5._mk, the
// bf16 operands of gauge_channels / clover_channels, and the bf16-psi hop
// of dslash_parity_pallas5) and dslash_ch_pallas5_msrc / _msrc_slab
// (K2d).  In the JAX package this is DiracParams.pallas_bf16, the
// sloppy operator of the mixed-precision solvers.
//
// What it computes: exactly K1's and K2's hop and epilogues
// (dslash_ch.cu, dslash_ch_msrc.cu), from the same device function
// (dslash_ch.cuh) instantiated with bf16 storage.  Every operand is
// widened to float on load (__bfloat162float, exact) and the arithmetic
// and the outputs are float, so on identical bf16 operands the result
// equals the float kernel's on the widened operands up to rounding order.
// Four instances:
//   qkx_dslash_ch_f32_g16      gauge and clover inverse bf16; psi, x,
//                              out, out2 float; every epilogue (the fused
//                              matpc chain of the sloppy operator);
//   qkx_dslash_ch_f32_g16c32   gauge bf16, clover inverse float; psi, x,
//                              out, out2 float; every epilogue, recon-12
//                              only (the compact channel operator of the
//                              bf16 tier, compact.py, keeps A^-1 in float:
//                              its chain with float spinor storage);
//   qkx_dslash_ch_f32_g16s16   gauge and psi bf16, out float, bare hop
//                              (Dirac.dslash of the bf16 tier: prepare,
//                              reconstruct, the full operator);
//   qkx_dslash_ch_msrc_f32_g16 K2 with bf16 gauge and clover inverse,
//                              float psi, x, out (launch order as K2).
//
// Bound: device-memory bytes, as K1.  Per output site, recon-12: the
// bare hop needs 192 B of gauge (384 in float) + psi in and out 192 B,
// 384 B against 576; the clover-forward + xpay hop 768 B against 1,248;
// the four-hop matpc^dag matpc chain 2,688 B against 4,320 (0.62x).  The
// arithmetic is unchanged (~1,300-1,900 flop a site in float), still far
// below the H100's ~20 flop/B balance point.  The design is K1's: one
// thread per output site, neighbouring threads on neighbouring w, so the
// two-byte channel loads stay coalesced (a warp moves 64 B per channel
// instead of 128).  Nothing is staged in shared memory yet.
//
// Host side: a plain C interface for ctypes with the argument lists of
// dslash_ch.cu and dslash_ch_msrc.cu.  Returns cudaGetLastError() after
// the launch (0 on success).

#include "dslash_ch.cuh"

using bf16 = __nv_bfloat16;

extern "C" int qkx_dslash_ch_f32_g16(const void* psi, const void* g,
                                     const void* cinv, const void* x,
                                     void* out, void* out2, int T, int Z,
                                     int W, int Xh, int parity, int dagger,
                                     int recon12, int twist, double ta,
                                     double tb, int clover, int xpay,
                                     double xc, int post, double pa,
                                     double pb, void* stream) {
  return qkx::launch_dslash<float, bf16, bf16, float, float, float>(
      psi, g, cinv, x, out, out2, T, Z, W, Xh, parity, dagger, recon12,
      twist, ta, tb, clover, xpay, xc, post, pa, pb, stream);
}

extern "C" int qkx_dslash_ch_f32_g16c32(const void* psi, const void* g,
                                        const void* cinv, const void* x,
                                        void* out, void* out2, int T, int Z,
                                        int W, int Xh, int parity,
                                        int dagger, int recon12, int twist,
                                        double ta, double tb, int clover,
                                        int xpay, double xc, int post,
                                        double pa, double pb, void* stream) {
  return qkx::launch_dslash_r12<float, bf16, float, float, float, float>(
      psi, g, cinv, x, out, out2, T, Z, W, Xh, parity, dagger, recon12,
      twist, ta, tb, clover, xpay, xc, post, pa, pb, stream);
}

extern "C" int qkx_dslash_ch_f32_g16s16(const void* psi, const void* g,
                                        const void* cinv, const void* x,
                                        void* out, void* out2, int T, int Z,
                                        int W, int Xh, int parity,
                                        int dagger, int recon12, int twist,
                                        double ta, double tb, int clover,
                                        int xpay, double xc, int post,
                                        double pa, double pb, void* stream) {
  return qkx::launch_dslash<float, bf16, bf16, bf16, bf16, float>(
      psi, g, cinv, x, out, out2, T, Z, W, Xh, parity, dagger, recon12,
      twist, ta, tb, clover, xpay, xc, post, pa, pb, stream);
}

extern "C" int qkx_dslash_ch_msrc_f32_g16(const void* psi, const void* g,
                                          const void* cinv, const void* x,
                                          void* out, int n, int T, int Z,
                                          int W, int Xh, int parity,
                                          int dagger, int recon12, int twist,
                                          double ta, double tb, int clover,
                                          int xpay, double xc, void* stream) {
  return qkx::launch_dslash_msrc<float, bf16, bf16, float, float, float>(
      psi, g, cinv, x, out, n, T, Z, W, Xh, parity, dagger, recon12, twist,
      ta, tb, clover, xpay, xc, stream);
}
