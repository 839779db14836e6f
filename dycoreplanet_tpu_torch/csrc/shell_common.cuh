// Index and ghost rules of the lat-lon spherical shell, shared by the
// hand-written kernels of dycoreplanet_tpu_torch (forcing.cu,
// richardson.cu, projection.cu).
//
// Layout: cell-centred fields are C-contiguous (nr, nlat, nlon) arrays,
// longitude fastest; a component stack is (C, nr, nlat, nlon). Every
// metric term of the shell is independent of longitude, so metrics come
// as (K, nr, nlat) channel stacks. Face arrays are cell-shaped LEFT
// faces: entry i is the face below cell i; the hi-wall face is an
// implicit zero.
//
// The ghost rules of ops/bc.py:
//   * longitude is periodic: index k wraps;
//   * latitude ghosts (POLE / POLE_FLIP): the ring value at lon + pi,
//     times +1 (u_r, T, p) or -1 (u_lat, u_lon);
//   * radial ghosts: NEUMANN (copy), ANTISYM (negate) or DIRICHLET
//     (2 * wall value - interior).
// K3 and K5 apply them as index arithmetic on global loads; K1 and K2
// stage tiles in shared memory and apply them while staging (below).
//
// Storage and compute types: a kernel instance reads and writes its
// fields in a storage type S (float, double or __nv_bfloat16) and
// computes in Compute<S>::type (float for bfloat16): each value is
// widened when it is read, the arithmetic runs in float, and each
// output is rounded once when it is stored (narrow<S>). Tables, shared
// memory and partial sums hold the compute type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Cycle probes at the phase boundaries of K1 and K2, compiled in only
// with -DK_PROBE (kernel_lib.use_macros; scripts/probe_k1_k2.py): thread
// 0 of each block adds the cycles since its previous probe to
// g_probe[k]. Without the flag both macros are empty.
#ifdef K_PROBE
__device__ unsigned long long g_probe[32];
extern "C" int probe_read(unsigned long long* h) {
  return (int)cudaMemcpyFromSymbol(h, g_probe, sizeof(g_probe));
}
extern "C" int probe_zero() {
  unsigned long long z[32] = {0};
  return (int)cudaMemcpyToSymbol(g_probe, z, sizeof(z));
}
#define PROBE_START long long probe_t_ = clock64()
#define PROBE(k)                                                        \
  do {                                                                  \
    if (threadIdx.x == 0) {                                             \
      const long long t_ = clock64();                                   \
      atomicAdd(&g_probe[k], (unsigned long long)(t_ - probe_t_));      \
      probe_t_ = t_;                                                    \
    }                                                                   \
  } while (0)
#else
#define PROBE_START \
  do {              \
  } while (0)
#define PROBE(k) \
  do {           \
  } while (0)
#endif

namespace shell {

template <typename S>
struct Compute {
  using type = S;
};
template <>
struct Compute<__nv_bfloat16> {
  using type = float;
};
template <typename S>
using compute_t = typename Compute<S>::type;

__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }

// a compute-type value stored as S: rounded to nearest (ties to even)
// for bfloat16, as torch's float -> bfloat16 conversion rounds
template <typename S>
__device__ __forceinline__ S narrow(compute_t<S> v) {
  if constexpr (std::is_same_v<S, __nv_bfloat16>)
    return __float2bfloat16_rn(v);
  else
    return v;
}

struct Dims {
  int nr, nlat, nlon;
  __device__ __forceinline__ int64_t n_cells() const {
    return (int64_t)nr * nlat * nlon;
  }
  __device__ __forceinline__ int64_t cell(int i, int j, int k) const {
    return ((int64_t)i * nlat + j) * nlon + k;
  }
  // lon-invariant metric index of (i, j)
  __device__ __forceinline__ int lm(int i, int j) const { return i * nlat + j; }
  __device__ __forceinline__ int wrap(int k) const {
    return k < 0 ? k + nlon : (k >= nlon ? k - nlon : k);
  }
  __device__ __forceinline__ int antipode(int k) const {
    return wrap(k + nlon / 2);
  }
  __device__ __forceinline__ void coords(int64_t c, int& i, int& j,
                                         int& k) const {
    k = (int)(c % nlon);
    int64_t t = c / nlon;
    j = (int)(t % nlat);
    i = (int)(t / nlat);
  }
};

enum Scheme { MUSCL = 0, UPWIND = 1, CENTERED = 2 };

template <typename T>
__device__ __forceinline__ T guard();
template <>
__device__ __forceinline__ float guard<float>() { return 0.f; }
template <>
__device__ __forceinline__ double guard<double>() { return 1e-300; }

// van Leer limited slope: harmonic mean of the one-sided differences,
// zero at extrema (the JAX function's 1e-300 guard rounds to 0 in f32);
// the quotient is formed on every lane and then selected, so that a warp
// does not diverge on the sign
template <typename T>
__device__ __forceinline__ T van_leer(T a, T b) {
  const T ab = a * b;
  const T q = T(2) * ab / (a + b + guard<T>());
  return ab > T(0) ? q : T(0);
}

// upwind-biased value at a face with velocity uf from the four cells
// around it (a b | c d); gl / gr: the cell b / c is a ghost, whose
// slope is 0 (the second ghost replicates the first). One limiter per
// face: the upwind side's slope is selected before it is formed.
template <typename T>
__device__ __forceinline__ T face_value(T a, T b, T c, T d, bool gl, bool gr,
                                        T uf, int scheme) {
  if (scheme == CENTERED) return T(0.5) * (b + c);
  const bool up = uf > T(0);
  if (scheme == UPWIND) return up ? b : c;
  const T s = van_leer<T>(up ? b - a : c - b, up ? c - b : d - c);
  const T slope = (up ? gl : gr) ? T(0) : s;
  return up ? b + T(0.5) * slope : c - T(0.5) * slope;
}

// Projection head of one cell (shared by the Richardson kernel K1 and
// the faces_div kernel K3): the left-face velocities of u* (antisym
// radial walls, zero wall face, zero-area pole face, periodic lon) and
// the raw Poisson right-hand side -vol * div(u*) / dt.
// Metric channels at (i, j): vol, ar_lo, ar_hi, alat_lo, alat_hi, alon.
struct HeadMetric {
  int vol, ar_lo, ar_hi, alat_lo, alat_hi, alon;
};

template <typename S, typename T = compute_t<S>>
__device__ __forceinline__ void faces_div_cell(
    const Dims& g, const S* __restrict__ u, const T* __restrict__ M,
    const HeadMetric& hm, int i, int j, int k, T dt, T& f0, T& f1, T& f2,
    T& rhs) {
  const int64_t N = g.n_cells();
  const S* u0 = u;
  const S* u1 = u + N;
  const S* u2 = u + 2 * N;
  const int64_t c = g.cell(i, j, k);
  const int mi = g.lm(i, j);
  const int64_t MS = (int64_t)g.nr * g.nlat;
  auto m = [&](int ch) { return M[ch * MS + mi]; };
  auto v = [](const S* f, int64_t idx) { return widen(f[idx]); };

  // radial: face i (0 at the inner wall) and face i+1 (0 at the outer)
  f0 = i == 0 ? T(0) : T(0.5) * (v(u0, g.cell(i - 1, j, k)) + v(u0, c));
  T f0_up = i + 1 < g.nr ? T(0.5) * (v(u0, c) + v(u0, g.cell(i + 1, j, k)))
                         : T(0);
  // latitude: the pole faces have zero area and zero velocity
  f1 = j == 0 ? T(0) : T(0.5) * (v(u1, g.cell(i, j - 1, k)) + v(u1, c));
  T f1_up = j + 1 < g.nlat
                ? T(0.5) * (v(u1, c) + v(u1, g.cell(i, j + 1, k)))
                : T(0);
  // longitude: periodic
  f2 = T(0.5) * (v(u2, g.cell(i, j, g.wrap(k - 1))) + v(u2, c));
  T f2_up = T(0.5) * (v(u2, c) + v(u2, g.cell(i, j, g.wrap(k + 1))));

  T aq_r_up = i + 1 < g.nr ? m(hm.ar_hi) * f0_up : T(0);
  T aq_l_up = j + 1 < g.nlat ? m(hm.alat_hi) * f1_up : T(0);
  T div = (aq_r_up - m(hm.ar_lo) * f0);
  div = div + (aq_l_up - m(hm.alat_lo) * f1);
  div = div + (m(hm.alon) * f2_up - m(hm.alon) * f2);
  T vol = m(hm.vol);
  div = div / vol;
  rhs = (-vol) * div / dt;
}

// ---------------------------------------------------------------------
// Tile staging (K1, K2): a block copies a box of a field into shared
// memory with the ghost rules applied as it goes, so that its compute
// loops read no ghost index.

// any integer k to [0, n): periodic longitude, also for halos wider
// than the grid
__device__ __forceinline__ int wrap_any(int k, int n) {
  if ((unsigned)k >= (unsigned)n) {
    k %= n;
    if (k < 0) k += n;
  }
  return k;
}

// f(a, b, c) over an nA x nB x nC box, c fastest, cells dealt to the NT
// threads of the block round-robin; the indices advance by carries, not
// divisions
template <int NT, typename F>
__device__ __forceinline__ void for_box(int nA, int nB, int nC, F&& f) {
  const int n = nA * nB * nC;
  int e = threadIdx.x;
  if (e >= n) return;
  int c = e % nC, t = e / nC;
  int b = t % nB, a = t / nB;
  const int step = NT;
  const int dc = step % nC, tq = step / nC;
  const int db = tq % nB, da = tq / nB;
  for (; e < n; e += step) {
    f(a, b, c);
    c += dc;
    b += db;
    a += da;
    if (c >= nC) { c -= nC; ++b; }
    if (b >= nB) { b -= nB; ++a; }
  }
}

// f(a, b, c0, len) over the rows of an nA x nB x nC box, each row cut
// into segments of at most 8 cells of nearly equal length, the segments
// dealt to the threads round-robin: a thread walks its segment along c,
// so that the row's (i, j) values and its neighbours along c stay in
// registers
template <int NT, typename F>
__device__ __forceinline__ void for_rows(int nA, int nB, int nC, F&& f) {
  const int nseg = (nC + 7) / 8;
  const int L = (nC + nseg - 1) / nseg;
  for_box<NT>(nA, nB, nseg, [&](int a, int b, int s) {
    const int c0 = s * L;
    if (c0 < nC) f(a, b, c0, min(L, nC - c0));
  });
}

// One value from device to shared memory without a register round trip
// (cp.async, sm_80 and later), so a thread keeps many copies in flight;
// valid = false writes zero and reads nothing (src must still be a
// mapped address). Complete with stage_commit + stage_wait, then a
// barrier before other threads read the value.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"((int)sizeof(T)),
               "r"(valid ? (int)sizeof(T) : 0)
               : "memory");
}
// a bfloat16 value into a float of shared memory: widened in a register
// (cp.async copies bytes and cannot widen); valid = false writes zero.
// Visible to other threads after the barrier that follows the staging.
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src,
                                      bool valid) {
  *dst = valid ? __bfloat162float(*src) : 0.f;
}
// 16 bytes from device to shared memory (cp.async.cg: cached in L2
// only), both addresses 16-byte aligned; valid = false writes zeros and
// reads nothing. Completes with stage's copies.
__device__ __forceinline__ void stage16(void* dst, const void* src,
                                        bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void stage_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Fixed-order sum of one value per thread into out[blockIdx.x * stride
// + slot]: a shared-memory tree, so the result does not depend on the
// order in which blocks run (no float atomics).
template <typename T, int BLOCK>
__device__ __forceinline__ void block_sum(T v, T* __restrict__ out,
                                          int stride, int slot) {
  __shared__ T buf[BLOCK];
  buf[threadIdx.x] = v;
  __syncthreads();
#pragma unroll
  for (int s = BLOCK / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) buf[threadIdx.x] += buf[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[(int64_t)blockIdx.x * stride + slot] = buf[0];
  __syncthreads();
}

// Second pass of the fixed-order reduction: one block sums nparts rows
// of `width` partials column by column into out[width].
template <typename T, int BLOCK>
__global__ void reduce_partials(const T* __restrict__ parts, int nparts,
                                int width, T* __restrict__ out) {
  __shared__ T buf[BLOCK];
  for (int w = 0; w < width; ++w) {
    T acc = T(0);
    for (int p = threadIdx.x; p < nparts; p += BLOCK)
      acc += parts[(int64_t)p * width + w];
    buf[threadIdx.x] = acc;
    __syncthreads();
    for (int s = BLOCK / 2; s > 0; s >>= 1) {
      if (threadIdx.x < s) buf[threadIdx.x] += buf[threadIdx.x + s];
      __syncthreads();
    }
    if (threadIdx.x == 0) out[w] = buf[0];
    __syncthreads();
  }
}

}  // namespace shell
