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
// On one GPU the whole field sits in device memory, so the ghost rules
// of ops/bc.py are index arithmetic on global loads:
//   * longitude is periodic: index k wraps;
//   * latitude ghosts (POLE / POLE_FLIP): the ring value at lon + pi,
//     times +1 (u_r, T, p) or -1 (u_lat, u_lon);
//   * radial ghosts: NEUMANN (copy), ANTISYM (negate) or DIRICHLET
//     (2 * wall value - interior).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace shell {

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

enum RadialRule { NEUMANN = 0, ANTISYM = 1, DIRICHLET = 2 };
enum Scheme { MUSCL = 0, UPWIND = 1, CENTERED = 2 };

// A ghost-aware read resolves to an interior cell and a sign:
// value = sign * f[idx] (+ offset for DIRICHLET, handled by the caller).
struct Ref {
  int64_t idx;
  float sign;  // +1 or -1: exact in float and double
};

// radial neighbour m in [-1, nr] of cell (., j, k)
__device__ __forceinline__ Ref ref_r(const Dims& g, int m, int j, int k,
                                     int lo, int hi) {
  if (m < 0) return Ref{g.cell(0, j, k), lo == ANTISYM ? -1.f : 1.f};
  if (m >= g.nr) return Ref{g.cell(g.nr - 1, j, k), hi == ANTISYM ? -1.f : 1.f};
  return Ref{g.cell(m, j, k), 1.f};
}

// latitude neighbour m in [-1, nlat] of cell (i, ., k); pole = +1 / -1
__device__ __forceinline__ Ref ref_lat(const Dims& g, int i, int m, int k,
                                       float pole) {
  if (m < 0) return Ref{g.cell(i, 0, g.antipode(k)), pole};
  if (m >= g.nlat) return Ref{g.cell(i, g.nlat - 1, g.antipode(k)), pole};
  return Ref{g.cell(i, m, k), 1.f};
}

template <typename T>
__device__ __forceinline__ T guard();
template <>
__device__ __forceinline__ float guard<float>() { return 0.f; }
template <>
__device__ __forceinline__ double guard<double>() { return 1e-300; }

// van Leer limited slope: harmonic mean of the one-sided differences,
// zero at extrema (the JAX function's 1e-300 guard rounds to 0 in f32)
template <typename T>
__device__ __forceinline__ T van_leer(T a, T b) {
  T ab = a * b;
  return ab > T(0) ? T(2) * ab / (a + b + guard<T>()) : T(0);
}

// MUSCL slope of cell m along an axis of n cells; a ghost cell's slope
// is 0 because the second ghost replicates the first
template <typename T, typename Get>
__device__ __forceinline__ T slope_at(const Get& get, int m, int n,
                                      bool periodic) {
  if (!periodic && (m < 0 || m >= n)) return T(0);
  T v = get(m);
  return van_leer<T>(v - get(m - 1), get(m + 1) - v);
}

// upwind-biased value at the left face of cell c (velocity uf there)
template <typename T, typename Get>
__device__ __forceinline__ T face_value(const Get& get, int c, int n,
                                        bool periodic, T uf, int scheme) {
  T vm = get(c - 1), v = get(c);
  if (scheme == CENTERED) return T(0.5) * (vm + v);
  if (scheme == UPWIND) return uf > T(0) ? vm : v;
  return uf > T(0) ? vm + T(0.5) * slope_at<T>(get, c - 1, n, periodic)
                   : v - T(0.5) * slope_at<T>(get, c, n, periodic);
}

// Projection head of one cell (shared by the Richardson kernel K1 and
// the faces_div kernel K3): the left-face velocities of u* (antisym
// radial walls, zero wall face, zero-area pole face, periodic lon) and
// the raw Poisson right-hand side -vol * div(u*) / dt.
// Metric channels at (i, j): vol, ar_lo, ar_hi, alat_lo, alat_hi, alon.
struct HeadMetric {
  int vol, ar_lo, ar_hi, alat_lo, alat_hi, alon;
};

template <typename T>
__device__ __forceinline__ void faces_div_cell(
    const Dims& g, const T* __restrict__ u, const T* __restrict__ M,
    const HeadMetric& hm, int i, int j, int k, T dt, T& f0, T& f1, T& f2,
    T& rhs) {
  const int64_t N = g.n_cells();
  const T* u0 = u;
  const T* u1 = u + N;
  const T* u2 = u + 2 * N;
  const int64_t c = g.cell(i, j, k);
  const int mi = g.lm(i, j);
  const int64_t MS = (int64_t)g.nr * g.nlat;
  auto m = [&](int ch) { return M[ch * MS + mi]; };

  // radial: face i (0 at the inner wall) and face i+1 (0 at the outer)
  f0 = i == 0 ? T(0) : T(0.5) * (u0[g.cell(i - 1, j, k)] + u0[c]);
  T f0_up = i + 1 < g.nr ? T(0.5) * (u0[c] + u0[g.cell(i + 1, j, k)]) : T(0);
  // latitude: the pole faces have zero area and zero velocity
  f1 = j == 0 ? T(0) : T(0.5) * (u1[g.cell(i, j - 1, k)] + u1[c]);
  T f1_up = j + 1 < g.nlat ? T(0.5) * (u1[c] + u1[g.cell(i, j + 1, k)]) : T(0);
  // longitude: periodic
  f2 = T(0.5) * (u2[g.cell(i, j, g.wrap(k - 1))] + u2[c]);
  T f2_up = T(0.5) * (u2[c] + u2[g.cell(i, j, g.wrap(k + 1))]);

  T aq_r_up = i + 1 < g.nr ? m(hm.ar_hi) * f0_up : T(0);
  T aq_l_up = j + 1 < g.nlat ? m(hm.alat_hi) * f1_up : T(0);
  T div = (aq_r_up - m(hm.ar_lo) * f0);
  div = div + (aq_l_up - m(hm.alat_lo) * f1);
  div = div + (m(hm.alon) * f2_up - m(hm.alon) * f2);
  T vol = m(hm.vol);
  div = div / vol;
  rhs = (-vol) * div / dt;
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
