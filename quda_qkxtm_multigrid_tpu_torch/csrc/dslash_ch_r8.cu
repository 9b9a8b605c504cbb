// The recon-8 gauge form of the fused Wilson hop (CUDA C++ for sm_90a):
// kernel K3.
//
// Replaces the JAX package's Pallas TPU kernel K1 with recon8=True,
// quda_qkxtm_multigrid_tpu/ops/dslash_pallas5.py: dslash_ch_pallas5 /
// dslash_ch_pallas5_slab with the gauge decode _plane_body._mat8 and the
// encoding of gauge_channels(recon8=True).  No production path of the
// JAX package passes recon8; it is reached from its tests and its
// launch-shape tuner, and here from ops/dslash_kernel.dslash_ch(recon8=
// True) and benchmarks.bench_recon8.
//
// What it computes: exactly K1's hop and epilogues (dslash_ch.cu), from
// the same device function (dslash_ch.cuh, RECON = 8), in float, on a
// gauge operand of 8 reals a link, [T, 64, Z, W] with channel
// (mu*2 + fb)*8 + j and j over [Re a2, Im a2, Re a3, Im a3, Re b1, Im b1,
// arg a1, arg c1] (rows a, b, c of the doubled link).  Each link is
// rebuilt in registers (decode_recon8): |a1| and |c1| from the unit norms
// of row 0 and column 0, one precise sincosf for each phase, and the
// rest from unitarity, which divides by |a2|^2 + |a3|^2 = 1 - |a1|^2.  So
// a link whose |a1| is near 1 loses digits, in the TPU kernel alike.
// Built without --use_fast_math: sqrtf and sincosf are the precise ones.
// The decode assumes SU(3) links, so a gauge with the antiperiodic t
// boundary's -1 has no recon-8 form: the wrapper (ops/dslash_kernel.py)
// and the encoder refuse it, and this kernel ignores the boundary bit.
//
// Bound: device-memory bytes.  The bare hop reads 256 B of gauge a site
// (384 with recon-12) and 96 + 96 B of spinor: 448 B against K1's 576,
// for ~50 more flop a link (~400 a site, on top of K1's 1,320), still far
// below the H100's balance point.  The design is K1's: one thread per
// output site, neighbouring threads on neighbouring w.
//
// Host side: one entry point with the argument list of dslash_ch.cu,
// float storage and every epilogue; the recon12 argument is not read.
// Returns cudaGetLastError() after the launch (0 on success).

#include "dslash_ch.cuh"

extern "C" int qkx_dslash_ch_f32_r8(const void* psi, const void* g,
                                    const void* cinv, const void* x,
                                    void* out, void* out2, int T, int Z,
                                    int W, int Xh, int parity, int dagger,
                                    int recon12, int twist, double ta,
                                    double tb, int clover, int xpay,
                                    double xc, int post, double pa,
                                    double pb, void* stream) {
  (void)recon12;
  return qkx::launch_dslash_recon<float, float, float, float, float, float,
                                  8>(
      psi, g, cinv, x, out, out2, T, Z, W, Xh, parity, dagger, twist, ta, tb,
      clover, xpay, xc, post, pa, pb, stream);
}
