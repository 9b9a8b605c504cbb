// Native host-side byte swap for the LIME / ILDG reader and writer of
// the PyTorch port (the JAX package's native/qkxtm_native.cpp, copied).
//
// The reference's LIME/ILDG reader is native C++ with MPI-IO and a
// hand-written big-endian swap (reference qkxtm/QKXTM_read_conf.h:299-764,
// byte-swap helpers qudaQKXTM_Kepler.h:22-60).  Here the file-system read
// is the OS's job; the endianness conversion of a multi-GB configuration
// is memory-bandwidth work, split over threads.
//
// A plain C ABI for ctypes, built on demand by io/_native.py into the
// checkout's build/ directory.

#include <cstdint>
#include <cstddef>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

template <typename Fn>
void parallel_chunks(size_t n, int nthreads, Fn&& fn) {
  if (nthreads <= 0) {
    nthreads = static_cast<int>(std::thread::hardware_concurrency());
    if (nthreads <= 0) nthreads = 1;
  }
  const size_t min_chunk = 1 << 16;
  size_t chunks = std::max<size_t>(1, std::min<size_t>(nthreads,
                                                       n / min_chunk));
  if (chunks <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> ts;
  size_t per = (n + chunks - 1) / chunks;
  for (size_t c = 0; c < chunks; ++c) {
    size_t lo = c * per, hi = std::min(n, lo + per);
    if (lo >= hi) break;
    ts.emplace_back([=, &fn] { fn(lo, hi); });
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// big-endian f64 -> native f64, n elements
void be64_to_f64(const void* src, void* dst, size_t n, int nthreads) {
  const uint64_t* s = static_cast<const uint64_t*>(src);
  uint64_t* d = static_cast<uint64_t*>(dst);
  parallel_chunks(n, nthreads, [&](size_t lo, size_t hi) {
    for (size_t i = lo; i < hi; ++i) d[i] = __builtin_bswap64(s[i]);
  });
}

// big-endian f32 -> native f64 (widening decode: ILDG single-precision
// configurations land directly in the solver's double tier)
void be32_to_f64(const void* src, void* dst, size_t n, int nthreads) {
  const uint32_t* s = static_cast<const uint32_t*>(src);
  double* d = static_cast<double*>(dst);
  parallel_chunks(n, nthreads, [&](size_t lo, size_t hi) {
    for (size_t i = lo; i < hi; ++i) {
      uint32_t v = __builtin_bswap32(s[i]);
      float f;
      std::memcpy(&f, &v, 4);
      d[i] = static_cast<double>(f);
    }
  });
}

// native f64 -> big-endian f64
void f64_to_be64(const void* src, void* dst, size_t n, int nthreads) {
  be64_to_f64(src, dst, n, nthreads);  // involution
}

// native f64 -> big-endian f32 (narrowing encode)
void f64_to_be32(const void* src, void* dst, size_t n, int nthreads) {
  const double* s = static_cast<const double*>(src);
  uint32_t* d = static_cast<uint32_t*>(dst);
  parallel_chunks(n, nthreads, [&](size_t lo, size_t hi) {
    for (size_t i = lo; i < hi; ++i) {
      float f = static_cast<float>(s[i]);
      uint32_t v;
      std::memcpy(&v, &f, 4);
      d[i] = __builtin_bswap32(v);
    }
  });
}

}  // extern "C"
