// Multi-source fused Wilson hop on the planar-channel layout (CUDA C++
// for sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel K2,
// quda_qkxtm_multigrid_tpu/ops/dslash_pallas5.py::dslash_ch_pallas5_msrc
// and its slab form dslash_ch_pallas5_msrc_slab (both reached through
// dslash_ch_msrc_auto).  The slab is a TPU VMEM tiling of the same
// computation, so this one kernel replaces both.
//
// What it computes: K1's hop and epilogues (dslash_ch.cu) for each of n
// sources that share one gauge field and one clover inverse:
//   psi, x, out, out2  [n, T, 24, Z, W] float, source s at offset
//   s*T*24*Z*W;  g [T, 96|144, Z, W] and cinv [T, 144, Z, W] shared by
//   every source.
// Epilogues: twist or chiral clover (fwd / dag), then xpay, then K1's
// optional second output (post = 1: A^dag of the result; 2: the twist
// b'(1 + i a' g5)), which lets the normal operator's four-hop chain run
// on a batch without a separate A^-1^dag pass.
//
// Bound: device-memory bytes.  Per output site the gauge (recon-12: 384
// B) and the clover inverse (576 B) are shared by the n sources, and
// each source reads psi and x and writes out (and out2): 288-384 B.  So
// the least traffic is 960 + n * 288 B a site (n = 8: 3.3 kB, 1.02 ms at
// 32^3x64 on an H100 SXM), far below the ~20 flop/B balance point of the
// ~1,900 flop a site and source.
//
// Design: one block of 128 threads per tile of 32 sites of w in one
// (t, z) row (kMsrcTile<float>, dslash_ch.cuh), as 4 warps, each a lane
// of sources.  The block first stages the tile's gauge and clover
// inverse in shared memory (cp.async, 16 B a copy; 30 KB), so device
// memory and L2 deliver them once per tile, not once per source; then
// each thread runs K1's device function (dslash_site) for its site and
// the sources of its lane, with the links and the clover inverse read
// from the tile at channel stride 32, psi, x and the outputs from device
// memory.  The four lanes keep four sources' psi loads in flight at
// once; the warp's 32 neighbouring w keep every channel load coalesced,
// and the staged rows are read without bank conflicts.  The arithmetic
// is K1's code in K1's order, so each source's result equals a K1 launch
// bit for bit.  89-96 registers, 5 blocks an SM.
//
// Measured (NVIDIA H100 80GB HBM3, PERF.md, section 6): at n = 8 the clover
// fwd + xpay form takes about 0.5 of its bound, and each further source
// costs about one single-source bare hop: with the shared operands
// staged, what bounds it is the per-source psi gather (8 neighbours, 768
// B a site from L1 and L2), not the device-memory bytes.
//
// Host side: a plain C interface for ctypes, as dslash_ch.cu.  Every
// pointer is a device pointer (cinv, x and out2 may be null where their
// epilogue is off); the stream is PyTorch's current stream.  Returns
// cudaGetLastError() after the launch (0 on success).  The kernel
// (dslash_ch_msrc_kernel) and its launcher are in dslash_ch.cuh; its
// bf16 operand tier (K2d) is in dslash_ch_bf16.cu.

#include "dslash_ch.cuh"

extern "C" int qkx_dslash_ch_msrc_f32(const void* psi, const void* g,
                                      const void* cinv, const void* x,
                                      void* out, void* out2, int n, int T,
                                      int Z, int W, int Xh, int parity,
                                      int dagger, int recon12, int twist,
                                      double ta, double tb, int clover,
                                      int xpay, double xc, int post,
                                      double pa, double pb, void* stream) {
  return qkx::launch_dslash_msrc<float, float, float, float, float, float>(
      psi, g, cinv, x, out, out2, n, T, Z, W, Xh, parity, dagger, recon12,
      twist, ta, tb, clover, xpay, xc, post, pa, pb, stream);
}
