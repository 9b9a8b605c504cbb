// Device code of the fused Wilson hop (see dslash_ch.cu for what it
// replaces and computes, the operand layout and what bounds it), and the
// host-side launchers that the entry points of dslash_ch.cu,
// dslash_ch_msrc.cu, dslash_ch_bf16.cu, dslash_ch_bf16s.cu,
// dslash_ch_r8.cu and dslash_ch_local.cu instantiate.
//
// Six types: R, the arithmetic type (float or double), and one storage
// type for each operand: G the gauge, C the clover inverse, S psi, X x,
// O the outputs (out and out2).  Each is R itself, or __nv_bfloat16 with
// R = float: the bf16 operand tier (dslash_ch_bf16.cu) and the bf16
// spinor storage (dslash_ch_bf16s.cu).  Every load widens to R and every
// store rounds once from R (a bf16 store to nearest even, as XLA's
// convert), so the arithmetic is the same code in every instance.
//
// RECON is the gauge operand's form: 18 (full links, 144 channels), 12
// (rows 0 and 1, row 2 = conj(r0 x r1) rebuilt in registers, 96
// channels) or 8 (8 reals a link, decoded in registers, 64 channels;
// dslash_ch_r8.cu).
//
// The antiperiodic t boundary: the gauge carries it as a -1 on the t
// links of global row T-1 (the forward links stored there and the
// backward links stored at row 0).  Recon-12 rebuilds row 2 as
// conj(r0 x r1), which is +row 2 for -U as well, so where the caller
// sets the bit kAntiperiodicT of ``parity`` the launchers pick the
// recon-12 instance with APBC = true, whose dslash_site negates the
// rebuilt row 2 of exactly those links; the periodic instances
// (APBC = false) compile to the code they had without it.  The recon-18
// forms read the sign with the links and ignore the bit; the recon-8
// form refuses such a gauge in its wrapper.  The reference keeps the
// same phase beside its reconstruct-12.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace qkx {

constexpr int kThreads = 128;

// A bit of DslashArgs::parity above the output parity (bit 0): the gauge
// carries the antiperiodic t boundary (see the top of this file).  Bit 0
// alone decides the checkerboard phase; the launchers read this bit.
constexpr int kAntiperiodicT = 2;

template <typename R>
struct Cplx {
  R re, im;
};

template <typename R>
__device__ __forceinline__ Cplx<R> cadd(Cplx<R> a, Cplx<R> b) {
  return {a.re + b.re, a.im + b.im};
}

// a * b
template <typename R>
__device__ __forceinline__ Cplx<R> cmul(Cplx<R> a, Cplx<R> b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}

// conj(a) * b
template <typename R>
__device__ __forceinline__ Cplx<R> cjmul(Cplx<R> a, Cplx<R> b) {
  return {a.re * b.re + a.im * b.im, a.re * b.im - a.im * b.re};
}

// i^code * z
template <typename R>
__device__ __forceinline__ Cplx<R> mul_phase(int code, Cplx<R> z) {
  switch (code & 3) {
    case 0: return z;
    case 1: return {-z.im, z.re};
    case 2: return {-z.re, -z.im};
    default: return {z.im, -z.re};
  }
}

// Row s of gamma_mu (DeGrand-Rossi basis) has one nonzero entry,
// i^gamma_phase(mu, s), in column gamma_col(mu, s).  Rows 2 and 3 of
// (1 + sg gamma_mu) are then sg i^phase times rows gamma_col of the
// upper half (the rank-2 projection).
__host__ __device__ constexpr int gamma_col(int mu, int s) {
  return mu < 2 ? 3 - s : (s ^ 2);
}

__host__ __device__ constexpr int gamma_phase(int mu, int s) {
  return mu == 0   ? (s < 2 ? 1 : 3)
         : mu == 1 ? ((s == 0 || s == 3) ? 2 : 0)
         : mu == 2 ? ((s == 0 || s == 3) ? 1 : 3)
                   : 0;
}

template <typename R, typename G, typename C, typename S, typename X,
          typename O>
struct DslashArgs {
  const S* psi;   // [T, 24, Z, W], opposite parity
  const G* g;     // [T, 64|96|144, Z, W], doubled links of the output parity
  const C* cinv;  // [T, 144, Z, W] or null
  const X* x;     // [T, 24, Z, W] or null
  O* out;         // [T, 24, Z, W]
  O* out2;        // [T, 24, Z, W] or null
  int T, Z, W, Xh;
  int parity;     // bit 0 the output parity; kAntiperiodicT
  int twist;      // 1: b(1 + i a g5) with (ta, tb)
  R ta, tb;
  int clover;     // 0 none, 1 A (fwd), 2 A^dag (dag)
  int xpay;       // 1: x + xc * (...)
  R xc;
  int post;       // 0 none, 1 A^dag of the result, 2 b'(1 + i a' g5) with (pa, pb)
  R pa, pb;
};

// The multi-source hop's tile (K2, K2d; dslash_ch_msrc.cu says why):
// kMsrcTile<G> sites of w of one (t, z) row per block of kThreads
// threads, kMsrcLanes<G> sources at a time; the block stages the tile's
// gauge and clover inverse in shared memory, channel-major
// [C][kMsrcTile<G>].  Chosen by measurement on an H100 (PERF.md, section 6):
// 32 sites and 4 lanes with float operands, 64 and 2 with bf16 ones,
// 30 KB of shared memory a block either way.
template <typename G>
constexpr int kMsrcTile = sizeof(G) == 2 ? 64 : 32;
template <typename G>
constexpr int kMsrcLanes = kThreads / kMsrcTile<G>;

// One site's column of the staged operands: channel ch of the gauge at
// g[ch * kMsrcTile<G>], of the clover inverse at c[ch * kMsrcTile<G>].
template <typename G, typename C>
struct TileOperands {
  const G* g;
  const C* c;
};

// The t-local hop's own arguments (dslash_ch_local.cu, K4 and K5), a
// second kernel parameter so that DslashArgs, and the code of every
// other kernel, stay as they were.  t does not wrap there.  The launch
// covers rows t0, t0 + tstep, ... (one per blockIdx.z).  The t-1
// neighbour of row 0 and the t+1 neighbour of row T-1 are the planes
// face_m and face_p (24 channels, or 12: the 2-spinor that the sender
// already projected; TMODE 2 and 3 of dslash_site).
template <typename S>
struct LocalArgs {
  const S* face_m;
  const S* face_p;
  int t0, tstep;
};

// The rows of a launch's block that hold global rows 0 and T-1 (outside
// [0, T) where a slab holds neither): their backward and forward t links
// carry the antiperiodic boundary's sign (the APBC instances' argument).
struct TRows {
  int first, last;
};

// The z and y faces of K4 on a box (dslash_ch_box.cu), beside the t faces
// of LocalArgs: zm / zp the z-1 neighbour of plane 0 and the z+1
// neighbour of plane Z-1, each [T, 24, 1, W] (channel stride W); wm / wp
// the y-1 neighbour of row 0 and the y+1 neighbour of row Y-1, each
// [T, 24, Z, Xh] (channel stride Z*Xh), read at the site's k.  Null for
// an axis that wraps in the box.  Only the box instances take it (ZW of
// dslash_site), in the trailing parameter pack after their TRows.
template <typename S>
struct BoxFaces {
  const S* zm;
  const S* zp;
  const S* wm;
  const S* wp;
};

// The members of dslash_site's trailing pack: a TRows, then, in the box
// instances, a BoxFaces.
__device__ __forceinline__ TRows rows_of(TRows r) { return r; }
template <typename F>
__device__ __forceinline__ TRows rows_of(TRows r, F) { return r; }
template <typename F>
__device__ __forceinline__ F faces_of(TRows, F f) { return f; }

// One stored real, widened on load (bf16 -> float is exact).
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ double ld(const double* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename R, typename T>
__device__ __forceinline__ Cplx<R> load_c(const T* base, int ch, int64_t zw) {
  return {static_cast<R>(ld(base + (int64_t)ch * zw)),
          static_cast<R>(ld(base + (int64_t)(ch + 1) * zw))};
}

// One real stored from the arithmetic type, rounded once.
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(double* p, double v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename O, typename R>
__device__ __forceinline__ void store_c(O* base, int ch, int64_t zw,
                                        Cplx<R> v) {
  st(base + (int64_t)ch * zw, v.re);
  st(base + (int64_t)(ch + 1) * zw, v.im);
}

__device__ __forceinline__ float max_r(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_r(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float sqrt_r(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_r(double v) { return sqrt(v); }
__device__ __forceinline__ void sincos_r(float v, float* s, float* c) {
  sincosf(v, s, c);
}
__device__ __forceinline__ void sincos_r(double v, double* s, double* c) {
  sincos(v, s, c);
}

// The SU(3) link from its 8-real encoding at channel base ch of gs:
// [Re a2, Im a2, Re a3, Im a3, Re b1, Im b1, arg a1, arg c1] (rows a, b,
// c).  |a1| and |c1| follow from the unit norm of row 0 and column 0;
// b2, b3, c2, c3 from the unitarity of the rest (the JAX package's
// _plane_body._mat8, term for term).  The decode divides by
// |a2|^2 + |a3|^2 = 1 - |a1|^2, so a link with |a1| near 1 loses digits.
template <typename R, typename G>
__device__ __forceinline__ void decode_recon8(const G* gs, int ch,
                                              int64_t zw, Cplx<R> (&u)[3][3]) {
  R e[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = static_cast<R>(ld(gs + (int64_t)(ch + j) * zw));
  const R a2r = e[0], a2i = e[1], a3r = e[2], a3i = e[3];
  const R b1r = e[4], b1i = e[5];
  const R n = a2r * a2r + a2i * a2i + a3r * a3r + a3i * a3i;
  const R a1m2 = max_r(R(1) - n, R(0));
  const R a1m = sqrt_r(a1m2);
  const R c1m = sqrt_r(max_r(R(1) - a1m2 - (b1r * b1r + b1i * b1i), R(0)));
  R s1, k1, s2, k2;
  sincos_r(e[6], &s1, &k1);
  sincos_r(e[7], &s2, &k2);
  const R a1r = a1m * k1, a1i = a1m * s1;
  const R c1r = c1m * k2, c1i = c1m * s2;
  const R rn = R(1) / n;
  const R tr = a1r * b1r + a1i * b1i;   // t = conj(a1) b1
  const R ti = a1r * b1i - a1i * b1r;
  const R b2r = -(tr * a2r - ti * a2i + (a3r * c1r - a3i * c1i)) * rn;
  const R b2i = -(tr * a2i + ti * a2r - (a3r * c1i + a3i * c1r)) * rn;
  const R b3r = -(tr * a3r - ti * a3i - (a2r * c1r - a2i * c1i)) * rn;
  const R b3i = -(tr * a3i + ti * a3r + (a2r * c1i + a2i * c1r)) * rn;
  const R c2r = (a3r * b1r - a3i * b1i) - (a1r * b3r - a1i * b3i);
  const R c2i = -((a3r * b1i + a3i * b1r) - (a1r * b3i + a1i * b3r));
  const R c3r = (a1r * b2r - a1i * b2i) - (a2r * b1r - a2i * b1i);
  const R c3i = -((a1r * b2i + a1i * b2r) - (a2r * b1i + a2i * b1r));
  u[0][0] = {a1r, a1i}; u[0][1] = {a2r, a2i}; u[0][2] = {a3r, a3i};
  u[1][0] = {b1r, b1i}; u[1][1] = {b2r, b2i}; u[1][2] = {b3r, b3i};
  u[2][0] = {c1r, c1i}; u[2][1] = {c2r, c2i}; u[2][2] = {c3r, c3i};
}

// v[kk] <- M v (dag = false) or M^dag v (dag = true) on the two chiral
// 6-blocks, kk = h*6 + r, M at channel ((h*6+r)*6+c)*2.
template <typename R, typename G>
__device__ __forceinline__ void chiral_apply(const G* m, int64_t zw, bool dag,
                                             const Cplx<R> (&v)[12],
                                             Cplx<R> (&res)[12]) {
#pragma unroll
  for (int kk = 0; kk < 12; ++kk) {
    const int h = kk / 6, r = kk % 6;
    Cplx<R> sum = {R(0), R(0)};
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      const int row = dag ? c : r, col = dag ? r : c;
      const Cplx<R> e = load_c<R>(m, ((h * 6 + row) * 6 + col) * 2, zw);
      sum = cadd(sum, dag ? cjmul(e, v[h * 6 + c]) : cmul(e, v[h * 6 + c]));
    }
    res[kk] = sum;
  }
}

template <typename R>
__device__ __forceinline__ Cplx<R> g5_rotate(Cplx<R> v, int kk, R a, R b) {
  const R ag = kk < 6 ? a : -a;
  return {b * (v.re - ag * v.im), b * (v.im + ag * v.re)};
}

// soff: offset of one source's psi, x, out and out2 within a batch of
// sources (0 for a single source); the gauge and clover are shared.
// TMODE: how the t neighbours are found.  0: t wraps periodically
// (K1, K2); the t-local hop, no wrap: 1 rows whose neighbours psi holds
// (K5's interior); 2 rows -1 and T are the 24-channel faces of ``l``
// (K4, K5's edges), a pointer swap and nothing else; 3 they are the
// 12-channel projected faces (K5's edges; see LocalArgs).
// TILE: where the links and the clover inverse are read, as a base
// pointer and a channel stride.  false: in device memory, stride Z*W;
// true: in the staged tile of shared memory (``tile``, K2 and K2d),
// stride kMsrcTile<G>.  The arithmetic is the same code either way.
// APBC: negate the rebuilt row 2 of the boundary's t links (recon-12,
// see the top of this file), whose rows the TRows of ``rows`` gives.
// The periodic instances take no such argument: their parameter list,
// and so their code, is the one the hop had before the flag (one more
// parameter, even unused, moved the registers of the t-local face
// instances; PERF.md section 6).
// ZW: K4 on a box (bit 0: z does not wrap, bit 1: y does not wrap); a
// z or y step off the box reads the BoxFaces that follows the TRows in
// ``rows``, in that face's own layout (BoxFaces).  0 in every other
// instance, whose code it leaves as it was.
template <typename R, typename G, typename C, typename S, typename X,
          typename O, bool DAG, int RECON, int TMODE = 0, bool TILE = false,
          bool APBC = false, int ZW = 0, typename... Rows>
__device__ __forceinline__ void dslash_site(
    const DslashArgs<R, G, C, S, X, O>& a, int t, int z, int w,
    int64_t soff, const LocalArgs<S>* l = nullptr,
    TileOperands<G, C> tile = {}, Rows... rows) {
  constexpr bool RECON12 = RECON == 12;
  constexpr int NROWS = RECON12 ? 2 : 3;
  constexpr int NG = RECON == 8 ? 64 : NROWS * 48;
  const int64_t zw = (int64_t)a.Z * a.W;
  const int64_t site = (int64_t)z * a.W + w;
  const int y = w / a.Xh, k = w - y * a.Xh;
  const bool s0 = ((t + z + y + a.parity) & 1) == 0;  // true x is even
  const int64_t ost = TILE ? (int64_t)kMsrcTile<G> : zw;  // operand channel stride
  const G* gs;
  if constexpr (TILE)
    gs = tile.g;
  else
    gs = a.g + (int64_t)t * NG * zw + site;

  Cplx<R> acc[4][3];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[s][c] = {R(0), R(0)};

#pragma unroll
  for (int mu = 0; mu < 4; ++mu) {
#pragma unroll
    for (int fb = 0; fb < 2; ++fb) {
      const bool fwd = fb == 0;
      // projector 1 + sg g_mu: sg = +1 (phase code 0) or -1 (code 2)
      const int sgc = (fwd ? DAG : !DAG) ? 0 : 2;
      int tn = t, zn = z, wn = w;
      if (mu == 3) {
        if constexpr (TMODE == 0)
          tn = fwd ? (t + 1 == a.T ? 0 : t + 1) : (t == 0 ? a.T - 1 : t - 1);
        else
          tn = fwd ? t + 1 : t - 1;   // -1 and T: a face
      } else if (mu == 2) {
        if constexpr ((ZW & 1) != 0)
          zn = fwd ? z + 1 : z - 1;   // -1 and Z: a face
        else
          zn = fwd ? (z + 1 == a.Z ? 0 : z + 1) : (z == 0 ? a.Z - 1 : z - 1);
      } else if (mu == 1) {
        if constexpr ((ZW & 2) != 0)
          wn = fwd ? w + a.Xh : w - a.Xh;   // off [0, W): a face
        else
          wn = fwd ? (w + a.Xh >= a.W ? w + a.Xh - a.W : w + a.Xh)
                   : (w < a.Xh ? w - a.Xh + a.W : w - a.Xh);
      } else if (fwd) {   // x: checkerboard rule, wrapping in the row
        wn = s0 ? w : (k == a.Xh - 1 ? w - (a.Xh - 1) : w + 1);
      } else {
        wn = s0 ? (k == 0 ? w + (a.Xh - 1) : w - 1) : w;
      }
      const S* pn = a.psi + soff + (int64_t)tn * 24 * zw + (int64_t)zn * a.W + wn;
      int64_t pst = zw;         // pn's channel stride
      bool projected = false;   // pn holds the 2-spinor hs itself
      if constexpr (TMODE >= 2) {
        if (mu == 3 && (fwd ? tn == a.T : tn < 0)) {
          pn = (fwd ? l->face_p : l->face_m) + site;
          projected = TMODE == 3;
        }
      }
      if constexpr (ZW != 0) {
        const auto f = faces_of(rows...);
        if ((ZW & 1) != 0 && mu == 2 && (fwd ? zn == a.Z : zn < 0)) {
          pn = (fwd ? f.zp : f.zm) + (int64_t)t * 24 * a.W + w;
          pst = a.W;
        } else if ((ZW & 2) != 0 && mu == 1 && (fwd ? wn >= a.W : wn < 0)) {
          pn = (fwd ? f.wp : f.wm) + ((int64_t)t * 24 * a.Z + z) * a.Xh + k;
          pst = (int64_t)a.Z * a.Xh;
        }
      }

      Cplx<R> hs[2][3];
      if (projected) {
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int c = 0; c < 3; ++c) hs[s][c] = load_c<R>(pn, (s * 3 + c) * 2, pst);
      } else {
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int c = 0; c < 3; ++c)
            hs[s][c] = cadd(load_c<R>(pn, (s * 3 + c) * 2, pst),
                            mul_phase(gamma_phase(mu, s) + sgc,
                                      load_c<R>(pn, (gamma_col(mu, s) * 3 + c) * 2, pst)));
      }

      Cplx<R> u[3][3];
      if constexpr (RECON == 8) {
        decode_recon8<R>(gs, (mu * 2 + fb) * 8, ost, u);
      } else {
#pragma unroll
        for (int r = 0; r < NROWS; ++r)
#pragma unroll
          for (int c = 0; c < 3; ++c)
            u[r][c] = load_c<R>(gs, (((mu * 2 + fb) * NROWS + r) * 3 + c) * 2, ost);
      }
      if (RECON12) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int c1 = (c + 1) % 3, c2 = (c + 2) % 3;
          const Cplx<R> p = cmul(u[0][c1], u[1][c2]);
          const Cplx<R> q = cmul(u[0][c2], u[1][c1]);
          u[2][c] = {p.re - q.re, q.im - p.im};  // conj(p - q)
        }
        // the boundary's -1
        if constexpr (APBC) {
          const TRows b = rows_of(rows...);
          if (mu == 3 && t == (fwd ? b.last : b.first)) {
#pragma unroll
            for (int c = 0; c < 3; ++c) u[2][c] = {-u[2][c].re, -u[2][c].im};
          }
        }
      }

#pragma unroll
      for (int s = 0; s < 2; ++s) {
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          Cplx<R> sum = {R(0), R(0)};
#pragma unroll
          for (int c = 0; c < 3; ++c)
            sum = cadd(sum, fwd ? cmul(u[r][c], hs[s][c])
                                : cjmul(u[c][r], hs[s][c]));
          acc[s][r] = cadd(acc[s][r], sum);
#pragma unroll
          for (int sl = 2; sl < 4; ++sl)
            if (gamma_col(mu, sl) == s)
              acc[sl][r] = cadd(acc[sl][r],
                                mul_phase(gamma_phase(mu, sl) + sgc, sum));
        }
      }
    }
  }

  Cplx<R> res[12];
#pragma unroll
  for (int kk = 0; kk < 12; ++kk) res[kk] = acc[kk / 3][kk % 3];
  // the site's clover inverse, where an epilogue reads it
  auto cinv_at = [&]() -> const C* {
    if constexpr (TILE)
      return tile.c;
    else
      return a.cinv + (int64_t)t * 144 * zw + site;
  };
  if (a.clover) {
    const Cplx<R> hop[12] = {res[0], res[1], res[2], res[3], res[4], res[5],
                             res[6], res[7], res[8], res[9], res[10], res[11]};
    chiral_apply(cinv_at(), ost, a.clover == 2, hop, res);
  }
  const X* xs = a.xpay ? a.x + soff + (int64_t)t * 24 * zw + site : nullptr;
  O* os = a.out + soff + (int64_t)t * 24 * zw + site;
#pragma unroll
  for (int kk = 0; kk < 12; ++kk) {
    Cplx<R> v = res[kk];
    if (a.twist) v = g5_rotate(v, kk, a.ta, a.tb);
    if (a.xpay) {
      const Cplx<R> xv = load_c<R>(xs, 2 * kk, zw);
      v = {xv.re + a.xc * v.re, xv.im + a.xc * v.im};
    }
    res[kk] = v;
    store_c(os, 2 * kk, zw, v);
  }
  if (a.post) {
    O* o2 = a.out2 + soff + (int64_t)t * 24 * zw + site;
    Cplx<R> v2[12];
    if (a.post == 1) {
      chiral_apply(cinv_at(), ost, true, res, v2);
    } else {
#pragma unroll
      for (int kk = 0; kk < 12; ++kk) v2[kk] = g5_rotate(res[kk], kk, a.pa, a.pb);
    }
#pragma unroll
    for (int kk = 0; kk < 12; ++kk) store_c(o2, 2 * kk, zw, v2[kk]);
  }
}

// One thread per output site: grid (ceil(W / blockDim.x), Z, T).
template <typename R, typename G, typename C, typename S, typename X,
          typename O, bool DAG, int RECON, bool APBC>
__global__ void __launch_bounds__(kThreads)
    dslash_ch_kernel(const DslashArgs<R, G, C, S, X, O> a) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= a.W) return;
  if constexpr (APBC)
    dslash_site<R, G, C, S, X, O, DAG, RECON, 0, false, true>(
        a, (int)blockIdx.z, (int)blockIdx.y, w, 0, nullptr, {},
        TRows{0, a.T - 1});
  else
    dslash_site<R, G, C, S, X, O, DAG, RECON>(a, (int)blockIdx.z,
                                              (int)blockIdx.y, w, 0);
}

// 16 bytes from device memory to shared memory, cached in L2 only; the
// copies of a thread land at cp_async_wait_all.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Stage ``nch`` channel rows of one tile, row ch at src + ch * zw, into
// dst[ch * TW + i] for i < width (the block's threads share the
// work): 16-byte copies when every row is whole and 16-byte aligned,
// otherwise one element at a time (the ragged last tile of a row, odd
// W).  Waits for nothing: cp_async_wait_all and a barrier follow.
template <int TW, typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int nch,
                                           int64_t zw, int width) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;
  constexpr int per = 16 / sizeof(T);   // elements a 16-byte copy
  const bool whole = width == TW &&
                     (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
                     (zw * (int64_t)sizeof(T)) % 16 == 0;
  if (whole) {
    constexpr int chunks = TW / per;
    for (int i = tid; i < nch * chunks; i += nthr) {
      const int ch = i / chunks, k = (i - ch * chunks) * per;
      cp_async16(dst + ch * TW + k, src + ch * zw + k);
    }
  } else {
    for (int i = tid; i < nch * TW; i += nthr) {
      const int ch = i / TW, k = i - ch * TW;
      if (k < width) dst[i] = src[ch * zw + k];
    }
  }
}

// n sources of one gauge field and clover inverse: grid (ceil(W / TW), Z,
// T), block (TW, min(n, kMsrcLanes<G>)), TW = kMsrcTile<G>.  The block
// stages its tile's gauge (and the clover inverse, where an epilogue
// reads it) once, then each thread computes its site for sources
// threadIdx.y, threadIdx.y + blockDim.y, ... with K1's device function,
// reading the staged operands (dslash_ch_msrc.cu says why).
template <typename R, typename G, typename C, typename S, typename X,
          typename O, bool DAG, int RECON, bool APBC>
__global__ void __launch_bounds__(kThreads)
    dslash_ch_msrc_kernel(const DslashArgs<R, G, C, S, X, O> a, int n) {
  constexpr int NG = RECON == 12 ? 96 : 144, TW = kMsrcTile<G>;
  extern __shared__ __align__(16) unsigned char smem[];
  G* sg = reinterpret_cast<G*>(smem);
  C* sc = reinterpret_cast<C*>(smem + NG * TW * sizeof(G));
  const int t = blockIdx.z, z = blockIdx.y, w0 = blockIdx.x * TW;
  const int64_t zw = (int64_t)a.Z * a.W;
  const int64_t row = (int64_t)z * a.W + w0;
  const int width = min(TW, a.W - w0);
  stage_rows<TW>(sg, a.g + (int64_t)t * NG * zw + row, NG, zw, width);
  if (a.clover || a.post == 1)
    stage_rows<TW>(sc, a.cinv + (int64_t)t * 144 * zw + row, 144, zw, width);
  cp_async_wait_all();
  __syncthreads();
  if ((int)threadIdx.x >= width) return;
  const TileOperands<G, C> tile = {sg + threadIdx.x, sc + threadIdx.x};
  const int64_t per_source = (int64_t)a.T * 24 * zw;
#pragma unroll 1
  for (int s = threadIdx.y; s < n; s += blockDim.y) {
    // the staged operands do not change between sources; without this
    // barrier the compiler keeps them in registers across the loop (168
    // and 255 registers for the float instances), and the occupancy drops
    asm volatile("" ::: "memory");
    if constexpr (APBC)
      dslash_site<R, G, C, S, X, O, DAG, RECON, 0, true, true>(
          a, t, z, w0 + (int)threadIdx.x, s * per_source, nullptr, tile,
          TRows{0, a.T - 1});
    else
      dslash_site<R, G, C, S, X, O, DAG, RECON, 0, true>(
          a, t, z, w0 + (int)threadIdx.x, s * per_source, nullptr, tile);
  }
}

// The t-local hop (K4, K5; TMODE 1, 2 or 3): one thread per output site
// of rows t0, t0 + tstep, ...: grid (ceil(W / blockDim.x), Z, rows).
template <typename R, typename G, typename C, typename S, typename X,
          typename O, bool DAG, int RECON, int TMODE>
__global__ void __launch_bounds__(kThreads)
    dslash_ch_local_kernel(const DslashArgs<R, G, C, S, X, O> a,
                           const LocalArgs<S> l) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= a.W) return;
  dslash_site<R, G, C, S, X, O, DAG, RECON, TMODE>(
      a, l.t0 + (int)blockIdx.z * l.tstep, (int)blockIdx.y, w, 0, &l);
}

// The t-local hop with the antiperiodic t boundary's sign, the slab's
// boundary rows in a third parameter (a kernel of its own, so that the
// periodic one keeps its parameter list).
template <typename R, typename G, typename C, typename S, typename X,
          typename O, bool DAG, int RECON, int TMODE>
__global__ void __launch_bounds__(kThreads)
    dslash_ch_local_apbc_kernel(const DslashArgs<R, G, C, S, X, O> a,
                                const LocalArgs<S> l, const TRows rows) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= a.W) return;
  dslash_site<R, G, C, S, X, O, DAG, RECON, TMODE, false, true>(
      a, l.t0 + (int)blockIdx.z * l.tstep, (int)blockIdx.y, w, 0, &l, {},
      rows);
}

// K4 on a box (ZW 1, 2 or 3: z, y or both split; t faces as TMODE 2):
// one thread per output site, grid (ceil(W / blockDim.x), Z, T).  A
// kernel of its own, with the z and y faces in one more parameter, so
// that K4's and K5's parameter lists stay as they were; the TRows is
// read only by the APBC instances.
template <typename R, typename G, typename C, typename S, typename X,
          typename O, bool DAG, bool APBC, int ZW>
__global__ void __launch_bounds__(kThreads)
    dslash_ch_box_kernel(const DslashArgs<R, G, C, S, X, O> a,
                         const LocalArgs<S> l, const BoxFaces<S> f,
                         const TRows rows) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= a.W) return;
  dslash_site<R, G, C, S, X, O, DAG, 12, 2, false, APBC, ZW>(
      a, (int)blockIdx.z, (int)blockIdx.y, w, 0, &l, {}, rows, f);
}

// ---- host side ------------------------------------------------------

template <typename R, typename G, typename C, typename S, typename X,
          typename O>
DslashArgs<R, G, C, S, X, O> make_args(
    const void* psi, const void* g, const void* cinv, const void* x,
    void* out, void* out2, int T, int Z, int W, int Xh, int parity,
    int twist, double ta, double tb, int clover, int xpay, double xc,
    int post, double pa, double pb) {
  DslashArgs<R, G, C, S, X, O> a;
  a.psi = static_cast<const S*>(psi);
  a.g = static_cast<const G*>(g);
  a.cinv = static_cast<const C*>(cinv);
  a.x = static_cast<const X*>(x);
  a.out = static_cast<O*>(out);
  a.out2 = static_cast<O*>(out2);
  a.T = T;
  a.Z = Z;
  a.W = W;
  a.Xh = Xh;
  a.parity = parity;
  a.twist = twist;
  a.ta = static_cast<R>(ta);
  a.tb = static_cast<R>(tb);
  a.clover = clover;
  a.xpay = xpay;
  a.xc = static_cast<R>(xc);
  a.post = post;
  a.pa = static_cast<R>(pa);
  a.pb = static_cast<R>(pb);
  return a;
}

// One single-source instance, dagger or not.
template <typename R, typename G, typename C, typename S, typename X,
          typename O, int RECON, bool APBC>
void launch_single(const DslashArgs<R, G, C, S, X, O>& a, int dagger,
                   cudaStream_t s) {
  const dim3 block(kThreads);
  const dim3 grid((a.W + kThreads - 1) / kThreads, a.Z, a.T);
  if (dagger)
    dslash_ch_kernel<R, G, C, S, X, O, true, RECON, APBC><<<grid, block, 0, s>>>(a);
  else
    dslash_ch_kernel<R, G, C, S, X, O, false, RECON, APBC><<<grid, block, 0, s>>>(a);
}

// Single-source launch of one gauge form (RECON; recon-12 with the
// antiperiodic bit takes the APBC instance); returns cudaGetLastError()
// (0 on success).
template <typename R, typename G, typename C, typename S, typename X,
          typename O, int RECON>
int launch_dslash_recon(const void* psi, const void* g, const void* cinv,
                        const void* x, void* out, void* out2, int T, int Z,
                        int W, int Xh, int parity, int dagger, int twist,
                        double ta, double tb, int clover, int xpay,
                        double xc, int post, double pa, double pb,
                        void* stream) {
  const DslashArgs<R, G, C, S, X, O> a = make_args<R, G, C, S, X, O>(
      psi, g, cinv, x, out, out2, T, Z, W, Xh, parity, twist, ta, tb, clover,
      xpay, xc, post, pa, pb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (RECON == 12 && (parity & kAntiperiodicT))
    launch_single<R, G, C, S, X, O, RECON, RECON == 12>(a, dagger, s);
  else
    launch_single<R, G, C, S, X, O, RECON, false>(a, dagger, s);
  return static_cast<int>(cudaGetLastError());
}

// Single-source launch, recon-12 or full links; returns
// cudaGetLastError() (0 on success).
template <typename R, typename G, typename C, typename S, typename X,
          typename O>
int launch_dslash(const void* psi, const void* g, const void* cinv,
                  const void* x, void* out, void* out2, int T, int Z, int W,
                  int Xh, int parity, int dagger, int recon12, int twist,
                  double ta, double tb, int clover, int xpay, double xc,
                  int post, double pa, double pb, void* stream) {
  if (recon12)
    return launch_dslash_recon<R, G, C, S, X, O, 12>(
        psi, g, cinv, x, out, out2, T, Z, W, Xh, parity, dagger, twist, ta,
        tb, clover, xpay, xc, post, pa, pb, stream);
  return launch_dslash_recon<R, G, C, S, X, O, 18>(
      psi, g, cinv, x, out, out2, T, Z, W, Xh, parity, dagger, twist, ta, tb,
      clover, xpay, xc, post, pa, pb, stream);
}

// Single-source launch of an instance built for recon-12 only (the
// forms of the compact channel chains): any other gauge form returns
// cudaErrorInvalidValue without launching.
template <typename R, typename G, typename C, typename S, typename X,
          typename O>
int launch_dslash_r12(const void* psi, const void* g, const void* cinv,
                      const void* x, void* out, void* out2, int T, int Z,
                      int W, int Xh, int parity, int dagger, int recon12,
                      int twist, double ta, double tb, int clover, int xpay,
                      double xc, int post, double pa, double pb,
                      void* stream) {
  if (!recon12) return static_cast<int>(cudaErrorInvalidValue);
  return launch_dslash_recon<R, G, C, S, X, O, 12>(
      psi, g, cinv, x, out, out2, T, Z, W, Xh, parity, dagger, twist, ta, tb,
      clover, xpay, xc, post, pa, pb, stream);
}

// One instance of the multi-source kernel, with the shared memory its
// staged operands take.
template <typename R, typename G, typename C, typename S, typename X,
          typename O, bool DAG, int RECON, bool APBC>
void launch_msrc_instance(const DslashArgs<R, G, C, S, X, O>& a, int n,
                          cudaStream_t s) {
  constexpr int NG = RECON == 12 ? 96 : 144, TW = kMsrcTile<G>;
  static_assert(TW * (NG * sizeof(G) + 144 * sizeof(C)) <= 48 * 1024,
                "the staged tile must fit the default 48 KB of dynamic "
                "shared memory (above it a launch needs an opt-in)");
  const bool clover = a.clover || a.post == 1;
  const size_t smem = TW * (NG * sizeof(G) + (clover ? 144 * sizeof(C) : 0));
  const dim3 block(TW, n < kMsrcLanes<G> ? n : kMsrcLanes<G>);
  const dim3 grid((a.W + TW - 1) / TW, a.Z, a.T);
  dslash_ch_msrc_kernel<R, G, C, S, X, O, DAG, RECON, APBC><<<grid, block, smem, s>>>(a, n);
}

// Multi-source launch, recon-12 or full links, with K1's epilogues and
// second output; returns cudaGetLastError() (0 on success).
template <typename R, typename G, typename C, typename S, typename X,
          typename O>
int launch_dslash_msrc(const void* psi, const void* g, const void* cinv,
                       const void* x, void* out, void* out2, int n, int T,
                       int Z, int W, int Xh, int parity, int dagger,
                       int recon12, int twist, double ta, double tb,
                       int clover, int xpay, double xc, int post, double pa,
                       double pb, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const DslashArgs<R, G, C, S, X, O> a = make_args<R, G, C, S, X, O>(
      psi, g, cinv, x, out, out2, T, Z, W, Xh, parity, twist, ta, tb,
      clover, xpay, xc, post, pa, pb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ap = recon12 && (parity & kAntiperiodicT);
  if (dagger) {
    if (ap) launch_msrc_instance<R, G, C, S, X, O, true, 12, true>(a, n, s);
    else if (recon12) launch_msrc_instance<R, G, C, S, X, O, true, 12, false>(a, n, s);
    else launch_msrc_instance<R, G, C, S, X, O, true, 18, false>(a, n, s);
  } else {
    if (ap) launch_msrc_instance<R, G, C, S, X, O, false, 12, true>(a, n, s);
    else if (recon12) launch_msrc_instance<R, G, C, S, X, O, false, 12, false>(a, n, s);
    else launch_msrc_instance<R, G, C, S, X, O, false, 18, false>(a, n, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The t-local hop's instance for the mode: 1 no faces, 2 faces of 24
// channels, 3 of 12 (see dslash_site).
template <typename R, typename G, typename C, typename S, typename X,
          typename O, bool DAG, int TMODE>
void launch_local_instance(bool apbc, dim3 grid, dim3 block, cudaStream_t s,
                           const DslashArgs<R, G, C, S, X, O>& a,
                           const LocalArgs<S>& l, TRows rows) {
  if (apbc)
    dslash_ch_local_apbc_kernel<R, G, C, S, X, O, DAG, 12, TMODE><<<grid, block, 0, s>>>(a, l, rows);
  else
    dslash_ch_local_kernel<R, G, C, S, X, O, DAG, 12, TMODE><<<grid, block, 0, s>>>(a, l);
}

template <typename R, typename G, typename C, typename S, typename X,
          typename O, bool DAG>
void launch_local_mode(int mode, bool apbc, dim3 grid, dim3 block,
                       cudaStream_t s, const DslashArgs<R, G, C, S, X, O>& a,
                       const LocalArgs<S>& l, TRows rows) {
  if (mode == 1)
    launch_local_instance<R, G, C, S, X, O, DAG, 1>(apbc, grid, block, s, a, l, rows);
  else if (mode == 2)
    launch_local_instance<R, G, C, S, X, O, DAG, 2>(apbc, grid, block, s, a, l, rows);
  else
    launch_local_instance<R, G, C, S, X, O, DAG, 3>(apbc, grid, block, s, a, l, rows);
}

// The t-local hop (recon-12 only, no second output): ``nrows`` output
// rows t0, t0 + tstep, ... of a block of T rows; faces as in LocalArgs,
// both given or both null (then no output row may be 0 or T-1: K5's
// interior); t_first, t_last as in TRows.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue without launching for
// another gauge form, no rows, one face alone or a face of neither 24
// nor 12 channels.
template <typename R, typename G, typename C, typename S, typename X,
          typename O>
int launch_dslash_local(const void* psi, const void* g, const void* cinv,
                        const void* x, void* out, const void* face_m,
                        const void* face_p, int face_ch, int T, int Z, int W,
                        int Xh, int parity, int t0, int tstep, int nrows,
                        int t_first, int t_last, int dagger, int recon12,
                        int twist, double ta, double tb, int clover,
                        int xpay, double xc, void* stream) {
  const bool faces = face_m != nullptr;
  if (!recon12 || nrows < 1 || faces != (face_p != nullptr) ||
      (face_ch != 24 && face_ch != 12))
    return static_cast<int>(cudaErrorInvalidValue);
  const DslashArgs<R, G, C, S, X, O> a = make_args<R, G, C, S, X, O>(
      psi, g, cinv, x, out, nullptr, T, Z, W, Xh, parity, twist, ta, tb,
      clover, xpay, xc, 0, 0.0, 0.0);
  const LocalArgs<S> l = {static_cast<const S*>(face_m),
                          static_cast<const S*>(face_p), t0, tstep};
  const TRows rows = {t_first, t_last};
  const dim3 block(kThreads);
  const dim3 grid((W + kThreads - 1) / kThreads, Z, nrows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mode = !faces ? 1 : (face_ch == 24 ? 2 : 3);
  const bool ap = (parity & kAntiperiodicT) != 0;
  if (dagger)
    launch_local_mode<R, G, C, S, X, O, true>(mode, ap, grid, block, s, a, l, rows);
  else
    launch_local_mode<R, G, C, S, X, O, false>(mode, ap, grid, block, s, a, l, rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename R, typename G, typename C, typename S, typename X,
          typename O, bool DAG, bool APBC>
void launch_box_zw(int zw_mode, dim3 grid, dim3 block, cudaStream_t s,
                   const DslashArgs<R, G, C, S, X, O>& a,
                   const LocalArgs<S>& l, const BoxFaces<S>& f, TRows rows) {
  if (zw_mode == 1)
    dslash_ch_box_kernel<R, G, C, S, X, O, DAG, APBC, 1><<<grid, block, 0, s>>>(a, l, f, rows);
  else if (zw_mode == 2)
    dslash_ch_box_kernel<R, G, C, S, X, O, DAG, APBC, 2><<<grid, block, 0, s>>>(a, l, f, rows);
  else
    dslash_ch_box_kernel<R, G, C, S, X, O, DAG, APBC, 3><<<grid, block, 0, s>>>(a, l, f, rows);
}

// K4 on a box (recon-12 only, no second output, every row): the t faces
// face_m / face_p (24 channels) and the z / y faces of BoxFaces, a pair
// per split axis; t_first, t_last as in TRows.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue without launching for
// another gauge form, a missing t face, one face of a pair alone, or no
// z or y face at all (that hop is K4's own).
template <typename R, typename G, typename C, typename S, typename X,
          typename O>
int launch_dslash_box(const void* psi, const void* g, const void* cinv,
                      const void* x, void* out, const void* face_m,
                      const void* face_p, const void* face_zm,
                      const void* face_zp, const void* face_wm,
                      const void* face_wp, int T, int Z, int W, int Xh,
                      int parity, int t_first, int t_last, int dagger,
                      int recon12, int twist, double ta, double tb,
                      int clover, int xpay, double xc, void* stream) {
  const bool zf = face_zm != nullptr, wf = face_wm != nullptr;
  if (!recon12 || face_m == nullptr || face_p == nullptr ||
      zf != (face_zp != nullptr) || wf != (face_wp != nullptr) || !(zf || wf))
    return static_cast<int>(cudaErrorInvalidValue);
  const DslashArgs<R, G, C, S, X, O> a = make_args<R, G, C, S, X, O>(
      psi, g, cinv, x, out, nullptr, T, Z, W, Xh, parity, twist, ta, tb,
      clover, xpay, xc, 0, 0.0, 0.0);
  const LocalArgs<S> l = {static_cast<const S*>(face_m),
                          static_cast<const S*>(face_p), 0, 1};
  const BoxFaces<S> f = {
      static_cast<const S*>(face_zm), static_cast<const S*>(face_zp),
      static_cast<const S*>(face_wm), static_cast<const S*>(face_wp)};
  const TRows rows = {t_first, t_last};
  const dim3 block(kThreads);
  const dim3 grid((W + kThreads - 1) / kThreads, Z, T);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mode = (zf ? 1 : 0) | (wf ? 2 : 0);
  const bool ap = (parity & kAntiperiodicT) != 0;
  if (dagger) {
    if (ap) launch_box_zw<R, G, C, S, X, O, true, true>(mode, grid, block, s, a, l, f, rows);
    else launch_box_zw<R, G, C, S, X, O, true, false>(mode, grid, block, s, a, l, f, rows);
  } else {
    if (ap) launch_box_zw<R, G, C, S, X, O, false, true>(mode, grid, block, s, a, l, f, rows);
    else launch_box_zw<R, G, C, S, X, O, false, false>(mode, grid, block, s, a, l, f, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace qkx
