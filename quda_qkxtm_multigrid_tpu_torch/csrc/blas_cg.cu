// The vector work of a conjugate-gradient iteration in three fused steps
// (kernel CG; CUDA C++ for sm_90a).
//
// Replaces no Pallas kernel: the JAX package's CG updates and reductions
// are XLA ops (quda_qkxtm_multigrid_tpu/solvers/cg.py), and the port's
// plain ones are eager PyTorch calls (ops/blas.py: cg_pap_plain,
// cg_r_update_norm_plain, cg_xp_update_plain).  Spelt as separate ops an
// iteration makes ~19 passes over its vectors (an axpy writes a temporary
// a * x and reads it back); these kernels make 10:
//   pap            Re<p, Ap> = sum p_i Ap_i over the real view     2 passes
//   r_update_norm  r <- r - alpha Ap in place, and |r|^2            3 passes
//   xp_update      x <- x + alpha p and p <- r + beta p in place,
//                  the old p read once for both                    5 passes
// A complex field is handed over as its real view: CG's alpha and beta
// are real, so the updates, Re<.,.> and |.|^2 are those of the real view.
//
// Bound: device-memory bytes.  A Mobius 5D half-parity vector at
// 48^3x24, Ls 24 holds 764 M floats (3.06 GB), far above the 50 MB L2, so
// every pass is a pass over device memory: 30.6 GB an iteration, 9.1 ms
// at 3.35 TB/s, against 10 flops a real (0.25 a byte).  Each kernel is a
// grid-stride loop over the flat buffer, one 16-byte vector (4 floats or
// 2 doubles) a thread a step, neighbouring threads on neighbouring
// addresses, with a scalar tail; where a pointer is off the 16-byte grid
// the whole launch takes one value a step.  Indices are 64-bit.  The grid
// is what the wrapper asks for (ops/blas.py: 8 blocks of 256 threads an
// SM, fewer for a short vector).
//
// The reductions sum in double for float and double fields alike (every
// product of two floats is exact in double): a thread over its stride,
// the block by warp shuffles and one shared-memory step, each block into
// its own slot of ``partials``; a second launch of one block then sums the
// partials in a fixed order into ``out``.  No atomics, so two runs on one
// card give the same bits.  alpha and beta are read from device memory
// (0-d double tensors), so CG's scalars never visit the host; an update
// rounds them to the field's type and applies each with one fma.
//
// Host side: a plain C interface for ctypes (no PyTorch headers).  Every
// pointer is a device pointer; the stream is PyTorch's current stream.
// A call neither synchronises nor allocates: ``partials`` (``blocks``
// doubles) and ``out`` come from the wrapper.  Returns cudaGetLastError()
// after the launches (0 on success), or cudaErrorInvalidValue without
// launching for an empty vector or grid.

#include <cuda_runtime.h>

#include <cstdint>

namespace qkx_cg {

constexpr int kThreads = 256;
constexpr int kFinishThreads = 1024;

// 16 bytes of T, loaded and stored as one vector
template <typename T>
struct alignas(16) Pack {
  static constexpr int n = 16 / sizeof(T);
  T v[n];
};

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// The sum of ``v`` over the block's NT threads, in thread 0, in a fixed
// order.
template <int NT>
__device__ __forceinline__ double block_sum(double v) {
  static_assert(NT % 32 == 0 && NT <= 1024, "whole warps, one block");
  __shared__ double warp_sums[NT / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < NT / 32 ? warp_sums[lane] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// The first element the scalar loop takes: past the vectors, or 0.
template <typename T, bool VEC>
__device__ __forceinline__ int64_t scalar_start(int64_t n) {
  return VEC ? n / Pack<T>::n * Pack<T>::n : 0;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    pap_kernel(const T* __restrict__ p, const T* __restrict__ ap, int64_t n,
               double* __restrict__ partials) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  double acc = 0.0;
  if constexpr (VEC) {
    using P = Pack<T>;
    const int64_t nv = n / P::n;
    const P* pv = reinterpret_cast<const P*>(p);
    const P* av = reinterpret_cast<const P*>(ap);
    for (int64_t i = tid; i < nv; i += stride) {
      const P a = pv[i], b = av[i];
#pragma unroll
      for (int j = 0; j < P::n; ++j) acc += (double)a.v[j] * (double)b.v[j];
    }
  }
  for (int64_t i = scalar_start<T, VEC>(n) + tid; i < n; i += stride)
    acc += (double)p[i] * (double)ap[i];
  acc = block_sum<kThreads>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    r_update_norm_kernel(T* __restrict__ r, const T* __restrict__ ap,
                         const double* __restrict__ alpha, int64_t n,
                         double* __restrict__ partials) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const T a = -(T)(*alpha);
  double acc = 0.0;
  if constexpr (VEC) {
    using P = Pack<T>;
    const int64_t nv = n / P::n;
    P* rv = reinterpret_cast<P*>(r);
    const P* av = reinterpret_cast<const P*>(ap);
    for (int64_t i = tid; i < nv; i += stride) {
      P x = rv[i];
      const P b = av[i];
#pragma unroll
      for (int j = 0; j < P::n; ++j) {
        x.v[j] = fma_t(a, b.v[j], x.v[j]);
        acc += (double)x.v[j] * (double)x.v[j];
      }
      rv[i] = x;
    }
  }
  for (int64_t i = scalar_start<T, VEC>(n) + tid; i < n; i += stride) {
    const T x = fma_t(a, ap[i], r[i]);
    r[i] = x;
    acc += (double)x * (double)x;
  }
  acc = block_sum<kThreads>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    xp_update_kernel(T* __restrict__ x, T* __restrict__ p,
                     const T* __restrict__ r,
                     const double* __restrict__ alpha,
                     const double* __restrict__ beta, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const T a = (T)(*alpha), b = (T)(*beta);
  if constexpr (VEC) {
    using P = Pack<T>;
    const int64_t nv = n / P::n;
    P* xv = reinterpret_cast<P*>(x);
    P* pv = reinterpret_cast<P*>(p);
    const P* rv = reinterpret_cast<const P*>(r);
    for (int64_t i = tid; i < nv; i += stride) {
      P xx = xv[i], pp = pv[i];
      const P rr = rv[i];
#pragma unroll
      for (int j = 0; j < P::n; ++j) {
        xx.v[j] = fma_t(a, pp.v[j], xx.v[j]);
        pp.v[j] = fma_t(b, pp.v[j], rr.v[j]);
      }
      xv[i] = xx;
      pv[i] = pp;
    }
  }
  for (int64_t i = scalar_start<T, VEC>(n) + tid; i < n; i += stride) {
    const T pp = p[i];
    x[i] = fma_t(a, pp, x[i]);
    p[i] = fma_t(b, pp, r[i]);
  }
}

// out = the sum of partials[0 .. blocks), in a fixed order.
__global__ void __launch_bounds__(kFinishThreads)
    finish_kernel(const double* __restrict__ partials, int blocks,
                  double* __restrict__ out) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < blocks; i += kFinishThreads)
    acc += partials[i];
  acc = block_sum<kFinishThreads>(acc);
  if (threadIdx.x == 0) *out = acc;
}

inline bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

inline int finish(const double* partials, int blocks, double* out,
                  cudaStream_t st) {
  finish_kernel<<<1, kFinishThreads, 0, st>>>(partials, blocks, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int pap(const void* p, const void* ap, int64_t n, int blocks, void* partials,
        void* out, void* stream) {
  if (n < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* pp = static_cast<const T*>(p);
  const auto* aa = static_cast<const T*>(ap);
  auto* part = static_cast<double*>(partials);
  if (aligned(p) && aligned(ap))
    pap_kernel<T, true><<<blocks, kThreads, 0, st>>>(pp, aa, n, part);
  else
    pap_kernel<T, false><<<blocks, kThreads, 0, st>>>(pp, aa, n, part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return finish(part, blocks, static_cast<double*>(out), st);
}

template <typename T>
int r_update_norm(void* r, const void* ap, const void* alpha, int64_t n,
                  int blocks, void* partials, void* out, void* stream) {
  if (n < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto* rr = static_cast<T*>(r);
  const auto* aa = static_cast<const T*>(ap);
  const auto* al = static_cast<const double*>(alpha);
  auto* part = static_cast<double*>(partials);
  if (aligned(r) && aligned(ap))
    r_update_norm_kernel<T, true>
        <<<blocks, kThreads, 0, st>>>(rr, aa, al, n, part);
  else
    r_update_norm_kernel<T, false>
        <<<blocks, kThreads, 0, st>>>(rr, aa, al, n, part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return finish(part, blocks, static_cast<double*>(out), st);
}

template <typename T>
int xp_update(void* x, void* p, const void* r, const void* alpha,
              const void* beta, int64_t n, int blocks, void* stream) {
  if (n < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto* xx = static_cast<T*>(x);
  auto* pp = static_cast<T*>(p);
  const auto* rr = static_cast<const T*>(r);
  const auto* al = static_cast<const double*>(alpha);
  const auto* be = static_cast<const double*>(beta);
  if (aligned(x) && aligned(p) && aligned(r))
    xp_update_kernel<T, true>
        <<<blocks, kThreads, 0, st>>>(xx, pp, rr, al, be, n);
  else
    xp_update_kernel<T, false>
        <<<blocks, kThreads, 0, st>>>(xx, pp, rr, al, be, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace qkx_cg

// (p, ap, n, blocks, partials, out, stream)
extern "C" int qkx_cg_pap_f32(const void* p, const void* ap, int64_t n,
                              int blocks, void* partials, void* out,
                              void* stream) {
  return qkx_cg::pap<float>(p, ap, n, blocks, partials, out, stream);
}

extern "C" int qkx_cg_pap_f64(const void* p, const void* ap, int64_t n,
                              int blocks, void* partials, void* out,
                              void* stream) {
  return qkx_cg::pap<double>(p, ap, n, blocks, partials, out, stream);
}

// (r, ap, alpha, n, blocks, partials, out, stream)
extern "C" int qkx_cg_r_update_norm_f32(void* r, const void* ap,
                                        const void* alpha, int64_t n,
                                        int blocks, void* partials,
                                        void* out, void* stream) {
  return qkx_cg::r_update_norm<float>(r, ap, alpha, n, blocks, partials, out,
                                      stream);
}

extern "C" int qkx_cg_r_update_norm_f64(void* r, const void* ap,
                                        const void* alpha, int64_t n,
                                        int blocks, void* partials,
                                        void* out, void* stream) {
  return qkx_cg::r_update_norm<double>(r, ap, alpha, n, blocks, partials,
                                       out, stream);
}

// (x, p, r, alpha, beta, n, blocks, stream)
extern "C" int qkx_cg_xp_update_f32(void* x, void* p, const void* r,
                                    const void* alpha, const void* beta,
                                    int64_t n, int blocks, void* stream) {
  return qkx_cg::xp_update<float>(x, p, r, alpha, beta, n, blocks, stream);
}

extern "C" int qkx_cg_xp_update_f64(void* x, void* p, const void* r,
                                    const void* alpha, const void* beta,
                                    int64_t n, int blocks, void* stream) {
  return qkx_cg::xp_update<double>(x, p, r, alpha, beta, n, blocks, stream);
}
