// K1: the implicit stage of the fast path — fixed-iteration
// Jacobi-Richardson solves of the momentum and temperature Helmholtz
// systems, their exactly tracked residuals, and the projection head.
//
// Replaces the Pallas kernel HelmholtzRichardsonPallas._build_call
// (dycoreplanet_tpu/ops/pallas_richardson.py:348). It solves
//
//   (V - dt/Re L) u* = V rhs_u   (3 components, x0 = rhs_u, iters_u)
//   (V - dt_T/Pe L) T = rhs_T    (x0 = T0, iters_T)
//
// with x <- x + r/D, r <- r - A (r/D), then emits the left-face
// velocities of u*, the raw Poisson right-hand side -vol*div(u*)/dt and
// the fixed-order sums [|r_u|^2, |b_u|^2, |r_T|^2, |b_T|^2, sum(rhs)].
//
// Bound: device-memory traffic. Unfused, each sweep reads and writes
// the 4 iterate and 4 residual channels; the least traffic for the same
// work is the 5 input fields (rhs_u, rhs_T, T0) read once and the 8
// output fields (u*, T_new, three faces, rhs_raw) written once: 13
// fields (~55 MB at 32x128x256 f32), against ~60 operations per cell
// per operator apply.
//
// Design (a first, unfused version): launches from this source, all on
// the caller's stream —
//   1. init: x = x0, r = b - A x0 for the 4 channels;
//   2. one sweep per Richardson iteration over the channels still
//      iterating: x += r/D, r' = r - A(r/D), ping-pong residual buffers
//      (the neighbour's r/D is recomputed from its r, no dx buffer);
//   3. head: faces, divergence, Poisson RHS and the per-block partial
//      sums (fixed-order shared-memory tree);
//   4. one-block fixed-order reduction of the partials.
// The operator is the ghost-based weak Laplacian itself (no wall BCs
// folded into metrics), one thread per cell. No float atomics: the sums
// are bitwise reproducible run to run.
#include "shell_common.cuh"

namespace {

using shell::Dims;
using shell::Ref;

constexpr int BLOCK = 256;

// metric channels at (i, j)
enum {
  M_VOL = 0, M_AR_LO, M_AR_HI, M_ALAT_LO, M_ALAT_HI, M_ALON,
  M_DR_LO, M_DR_HI, M_DLAT_LO, M_DLAT_HI, M_DLON,
  M_LD0, M_LD1, M_LD2, M_LD3,  // -weak_lap diagonals per channel
  M_K
};

// channel c: 0 u_r, 1 u_lat, 2 u_lon, 3 T (homogeneous BCs)
__device__ __forceinline__ int hi_rule(int c) {
  return c == 0 ? shell::ANTISYM : shell::NEUMANN;
}
__device__ __forceinline__ float pole_sign(int c) {
  return (c == 1 || c == 2) ? -1.f : 1.f;
}

template <typename T>
struct Ctx {
  Dims g;
  const T* M;
  int64_t MS;  // nr * nlat
  __device__ __forceinline__ T m(int ch, int i, int j) const {
    return M[ch * MS + g.lm(i, j)];
  }
};

// Jacobi denominator D = vol + coef * Ld of channel c at (i, j)
template <typename T>
__device__ __forceinline__ T diag_of(const Ctx<T>& X, int c, int i, int j,
                                     T coef) {
  return X.m(M_VOL, i, j) + coef * X.m(M_LD0 + c, i, j);
}

// weak Laplacian of the field v(.) at (i, j, k) for channel c, where
// v(idx, ii, jj) reads the interior cell idx at (ii, jj); ghosts follow
// the channel's homogeneous rules
template <typename T, typename V>
__device__ __forceinline__ T weak_lap(const Ctx<T>& X, const V& v, int c,
                                      int i, int j, int k) {
  const Dims& g = X.g;
  const T f = v(g.cell(i, j, k), i, j);
  auto rv = [&](int q) {
    Ref r = shell::ref_r(g, q, j, k, shell::ANTISYM, hi_rule(c));
    int ii = q < 0 ? 0 : (q >= g.nr ? g.nr - 1 : q);
    return T(r.sign) * v(r.idx, ii, j);
  };
  auto lv = [&](int q) {
    Ref r = shell::ref_lat(g, i, q, k, pole_sign(c));
    int jj = q < 0 ? 0 : (q >= g.nlat ? g.nlat - 1 : q);
    return T(r.sign) * v(r.idx, i, jj);
  };
  auto ov = [&](int q) { return v(g.cell(i, j, g.wrap(q)), i, j); };

  T agl = X.m(M_AR_LO, i, j) * ((f - rv(i - 1)) / X.m(M_DR_LO, i, j));
  T agh = X.m(M_AR_HI, i, j) * ((rv(i + 1) - f) / X.m(M_DR_HI, i, j));
  T out = agh - agl;
  agl = X.m(M_ALAT_LO, i, j) * ((f - lv(j - 1)) / X.m(M_DLAT_LO, i, j));
  agh = X.m(M_ALAT_HI, i, j) * ((lv(j + 1) - f) / X.m(M_DLAT_HI, i, j));
  out = out + (agh - agl);
  const T alon = X.m(M_ALON, i, j), dlon = X.m(M_DLON, i, j);
  agl = alon * ((f - ov(k - 1)) / dlon);
  agh = alon * ((ov(k + 1) - f) / dlon);
  return out + (agh - agl);
}

template <typename T>
__global__ void rich_init(Dims g, const T* __restrict__ M,
                          const T* __restrict__ rhs_u,
                          const T* __restrict__ rhs_T,
                          const T* __restrict__ T0, T coef_u, T coef_T,
                          T* __restrict__ x_u, T* __restrict__ x_T,
                          T* __restrict__ r_u, T* __restrict__ r_T) {
  const int64_t N = g.n_cells();
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= N) return;
  int i, j, k;
  g.coords(c, i, j, k);
  Ctx<T> X{g, M, (int64_t)g.nr * g.nlat};
  const T vol = X.m(M_VOL, i, j);
  for (int q = 0; q < 3; ++q) {
    const T* x0 = rhs_u + q * N;
    auto v = [&](int64_t idx, int, int) { return x0[idx]; };
    T Ax = vol * x0[c] - coef_u * weak_lap<T>(X, v, q, i, j, k);
    x_u[q * N + c] = x0[c];
    r_u[q * N + c] = vol * x0[c] - Ax;  // b = vol * rhs_u
  }
  auto v = [&](int64_t idx, int, int) { return T0[idx]; };
  T Ax = vol * T0[c] - coef_T * weak_lap<T>(X, v, 3, i, j, k);
  x_T[c] = T0[c];
  r_T[c] = rhs_T[c] - Ax;
}

template <typename T>
__global__ void rich_sweep(Dims g, const T* __restrict__ M, T coef_u,
                           T coef_T, int active_u, int active_T,
                           const T* __restrict__ ru_in,
                           T* __restrict__ ru_out,
                           const T* __restrict__ rT_in,
                           T* __restrict__ rT_out, T* __restrict__ x_u,
                           T* __restrict__ x_T) {
  const int64_t N = g.n_cells();
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= N) return;
  int i, j, k;
  g.coords(c, i, j, k);
  Ctx<T> X{g, M, (int64_t)g.nr * g.nlat};
  const T vol = X.m(M_VOL, i, j);
  for (int q = 0; q < 4; ++q) {
    const bool mom = q < 3;
    if (mom ? !active_u : !active_T) continue;
    const T coef = mom ? coef_u : coef_T;
    const T* rin = mom ? ru_in + q * N : rT_in;
    // dx = r / D at any cell, recomputed from its residual
    auto dx = [&](int64_t idx, int ii, int jj) {
      return rin[idx] / diag_of<T>(X, q, ii, jj, coef);
    };
    const T d = dx(c, i, j);
    T Ad = vol * d - coef * weak_lap<T>(X, dx, q, i, j, k);
    if (mom) {
      x_u[q * N + c] = x_u[q * N + c] + d;
      ru_out[q * N + c] = rin[c] - Ad;
    } else {
      x_T[c] = x_T[c] + d;
      rT_out[c] = rin[c] - Ad;
    }
  }
}

template <typename T>
__global__ void rich_head(Dims g, const T* __restrict__ M,
                          const T* __restrict__ u_star,
                          const T* __restrict__ r_u,
                          const T* __restrict__ r_T,
                          const T* __restrict__ rhs_u,
                          const T* __restrict__ rhs_T, T dt,
                          T* __restrict__ f0, T* __restrict__ f1,
                          T* __restrict__ f2, T* __restrict__ rhs_raw,
                          T* __restrict__ parts) {
  const int64_t N = g.n_cells();
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  T s_ru = T(0), s_bu = T(0), s_rT = T(0), s_bT = T(0), s_rhs = T(0);
  if (c < N) {
    int i, j, k;
    g.coords(c, i, j, k);
    const shell::HeadMetric hm{M_VOL, M_AR_LO, M_AR_HI, M_ALAT_LO,
                               M_ALAT_HI, M_ALON};
    T a0, a1, a2, rhs;
    shell::faces_div_cell<T>(g, u_star, M, hm, i, j, k, dt, a0, a1, a2, rhs);
    f0[c] = a0;
    f1[c] = a1;
    f2[c] = a2;
    rhs_raw[c] = rhs;
    const T vol = M[g.lm(i, j)];
    for (int q = 0; q < 3; ++q) {
      T r = r_u[q * N + c];
      T b = vol * rhs_u[q * N + c];
      s_ru += r * r;
      s_bu += b * b;
    }
    s_rT = r_T[c] * r_T[c];
    s_bT = rhs_T[c] * rhs_T[c];
    s_rhs = rhs;
  }
  shell::block_sum<T, BLOCK>(s_ru, parts, 5, 0);
  shell::block_sum<T, BLOCK>(s_bu, parts, 5, 1);
  shell::block_sum<T, BLOCK>(s_rT, parts, 5, 2);
  shell::block_sum<T, BLOCK>(s_bT, parts, 5, 3);
  shell::block_sum<T, BLOCK>(s_rhs, parts, 5, 4);
}

template <typename T>
int launch(int nr, int nlat, int nlon, const T* M, const T* rhs_u,
           const T* rhs_T, const T* T0, double dt, double iRe, double iPe,
           double dt_T_factor, int iters_u, int iters_T, T* u_star,
           T* T_new, T* ru_a, T* ru_b, T* rT_a, T* rT_b, T* f0, T* f1, T* f2,
           T* rhs_raw, T* parts, T* sums, void* stream) {
  Dims g{nr, nlat, nlon};
  const int64_t N = (int64_t)nr * nlat * nlon;
  const unsigned grid = (unsigned)((N + BLOCK - 1) / BLOCK);
  cudaStream_t s = (cudaStream_t)stream;
  const T dt_t = T(dt);
  const T coef_u = dt_t * T(iRe);
  const T coef_T = (dt_t * T(dt_T_factor)) * T(iPe);
  rich_init<T><<<grid, BLOCK, 0, s>>>(g, M, rhs_u, rhs_T, T0, coef_u, coef_T,
                                      u_star, T_new, ru_a, rT_a);
  int err = (int)cudaGetLastError();
  if (err) return err;
  T *ru_in = ru_a, *ru_out = ru_b, *rT_in = rT_a, *rT_out = rT_b;
  const int n_sweeps = iters_u > iters_T ? iters_u : iters_T;
  for (int it = 0; it < n_sweeps; ++it) {
    const int au = it < iters_u, aT = it < iters_T;
    rich_sweep<T><<<grid, BLOCK, 0, s>>>(g, M, coef_u, coef_T, au, aT,
                                         ru_in, ru_out, rT_in, rT_out,
                                         u_star, T_new);
    err = (int)cudaGetLastError();
    if (err) return err;
    if (au) { T* t = ru_in; ru_in = ru_out; ru_out = t; }
    if (aT) { T* t = rT_in; rT_in = rT_out; rT_out = t; }
  }
  rich_head<T><<<grid, BLOCK, 0, s>>>(g, M, u_star, ru_in, rT_in, rhs_u,
                                      rhs_T, dt_t, f0, f1, f2, rhs_raw,
                                      parts);
  err = (int)cudaGetLastError();
  if (err) return err;
  shell::reduce_partials<T, BLOCK><<<1, BLOCK, 0, s>>>(parts, (int)grid, 5,
                                                       sums);
  return (int)cudaGetLastError();
}

}  // namespace

#define RICHARDSON_ENTRY(NAME, T)                                             \
  extern "C" int NAME(int nr, int nlat, int nlon, const T* M, const T* rhs_u, \
                      const T* rhs_T, const T* T0, double dt, double iRe,     \
                      double iPe, double dt_T_factor, int iters_u,            \
                      int iters_T, T* u_star, T* T_new, T* ru_a, T* ru_b,     \
                      T* rT_a, T* rT_b, T* f0, T* f1, T* f2, T* rhs_raw,      \
                      T* parts, T* sums, void* stream) {                      \
    return launch<T>(nr, nlat, nlon, M, rhs_u, rhs_T, T0, dt, iRe, iPe,       \
                     dt_T_factor, iters_u, iters_T, u_star, T_new, ru_a,      \
                     ru_b, rT_a, rT_b, f0, f1, f2, rhs_raw, parts, sums,      \
                     stream);                                                 \
  }

RICHARDSON_ENTRY(dp_richardson_f32, float)
RICHARDSON_ENTRY(dp_richardson_f64, double)
