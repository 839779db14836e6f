// The two projection stages around the Poisson solve:
//
// K3: the pre-Poisson projection head on its own — the steps that
// bypass the Richardson kernel (escalated, full-CG and direct-Helmholtz
// steps) take it.
//
// Replaces the Pallas kernel ShellProjectionPallas._build_faces_div
// (dycoreplanet_tpu/ops/pallas_stencil.py:842): u* -> left-face
// velocities (antisym radial wall ghosts, zero wall face, zero-area
// pole face, periodic lon), the raw Poisson right-hand side
// -vol*div(u*)/dt and its sum. The per-cell device code is shared with
// K1's projection head (shell::faces_div_cell in shell_common.cuh).
//
// Bound: device-memory traffic: u* (3 fields) read, three faces and
// rhs_raw written — 7 fields (~29 MB at 32x128x256 f32), against ~25
// operations per cell.
//
// Design: one thread per cell; per-block partial sums of rhs by a
// fixed-order shared-memory tree, then a one-block fixed-order pass
// (no float atomics).
//
// K5: the post-Poisson correction, run once by every projection.
//
// Replaces the Pallas kernel ShellProjectionPallas._build_correct
// (dycoreplanet_tpu/ops/pallas_stencil.py:920): with phi' = phi - mean,
// the left faces uf - dt * grad_f(phi') (radial wall face and pole face
// zeroed), the cell velocity u* - dt * centred grad(phi') (radial
// Neumann ghosts, pole ghosts = the ring at lon + pi with sign +1,
// periodic lon) and p + phi' (incremental) or phi'.
//
// Bound: device-memory traffic: u* (3 fields), phi, three faces and p
// read, u (3 fields), three faces and p written — 15 fields (~62.9 MB at
// 32x128x256 f32), against ~30 operations per cell.
//
// Both come in float, double and bfloat16 storage (shell_common.cuh): the
// bfloat16 forms read and write bfloat16 fields and compute, keep their
// metric tables and sum the right-hand side in float.
//
// Design: one thread per cell, longitude fastest; ghosts are index
// arithmetic (shell_common.cuh); the mean of phi arrives as a device
// scalar, so the host never waits. Each neighbour's phi' is formed as
// phi - mean before differencing, as the plain version rounds it, and
// the metric is the per-face distance of the geometry (not a scalar dr
// and dlat, which the Pallas kernel may use because radii are uniform).
#include "shell_common.cuh"

namespace {

using shell::Dims;

constexpr int BLOCK = 256;

// metric channels at (i, j)
enum { M_VOL = 0, M_AR_LO, M_AR_HI, M_ALAT_LO, M_ALAT_HI, M_ALON, M_K };

template <typename S, typename T = shell::compute_t<S>>
__global__ void faces_div_kernel(Dims g, const T* __restrict__ M,
                                 const S* __restrict__ u_star, T dt,
                                 S* __restrict__ f0, S* __restrict__ f1,
                                 S* __restrict__ f2, S* __restrict__ rhs_raw,
                                 T* __restrict__ parts) {
  const int64_t N = g.n_cells();
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  T s = T(0);
  if (c < N) {
    int i, j, k;
    g.coords(c, i, j, k);
    const shell::HeadMetric hm{M_VOL, M_AR_LO, M_AR_HI, M_ALAT_LO,
                               M_ALAT_HI, M_ALON};
    T a0, a1, a2, rhs;
    shell::faces_div_cell<S>(g, u_star, M, hm, i, j, k, dt, a0, a1, a2, rhs);
    f0[c] = shell::narrow<S>(a0);
    f1[c] = shell::narrow<S>(a1);
    f2[c] = shell::narrow<S>(a2);
    rhs_raw[c] = shell::narrow<S>(rhs);
    s = rhs;
  }
  shell::block_sum<T, BLOCK>(s, parts, 1, 0);
}

template <typename S, typename T = shell::compute_t<S>>
int launch(int nr, int nlat, int nlon, const T* M, const S* u_star,
           double dt, S* f0, S* f1, S* f2, S* rhs_raw, T* parts, T* sums,
           void* stream) {
  Dims g{nr, nlat, nlon};
  const int64_t N = (int64_t)nr * nlat * nlon;
  const unsigned grid = (unsigned)((N + BLOCK - 1) / BLOCK);
  cudaStream_t s = (cudaStream_t)stream;
  faces_div_kernel<S><<<grid, BLOCK, 0, s>>>(g, M, u_star, T(dt), f0, f1, f2,
                                             rhs_raw, parts);
  int err = (int)cudaGetLastError();
  if (err) return err;
  shell::reduce_partials<T, BLOCK><<<1, BLOCK, 0, s>>>(parts, (int)grid, 1,
                                                       sums);
  return (int)cudaGetLastError();
}

// correction metric channels at (i, j): the distances across the lo
// and hi faces of axes r and lat, and across the lon faces
enum { C_DR_LO = 0, C_DR_HI, C_DLAT_LO, C_DLAT_HI, C_DLON, C_K };

template <typename S, typename T = shell::compute_t<S>>
__global__ void correct_kernel(Dims g, const T* __restrict__ M,
                               const S* __restrict__ u_star,
                               const S* __restrict__ phi,
                               const S* __restrict__ uf0,
                               const S* __restrict__ uf1,
                               const S* __restrict__ uf2,
                               const S* __restrict__ pres,
                               const S* __restrict__ phi_mean, T dt,
                               int incremental, S* __restrict__ u_new,
                               S* __restrict__ f0, S* __restrict__ f1,
                               S* __restrict__ f2, S* __restrict__ p_new) {
  const int64_t N = g.n_cells();
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= N) return;
  int i, j, k;
  g.coords(c, i, j, k);
  const int mi = g.lm(i, j);
  const int64_t MS = (int64_t)g.nr * g.nlat;
  auto m = [&](int ch) { return M[ch * MS + mi]; };
  using shell::narrow;
  using shell::widen;
  const T pm = widen(phi_mean[0]);
  auto p = [&](int64_t idx) { return widen(phi[idx]) - pm; };

  const T pc = p(c);
  // radial: Neumann ghosts, so the wall-face gradients are 0
  const T gr_lo = i == 0 ? T(0) : (pc - p(g.cell(i - 1, j, k))) / m(C_DR_LO);
  const T gr_hi =
      i + 1 < g.nr ? (p(g.cell(i + 1, j, k)) - pc) / m(C_DR_HI) : T(0);
  // latitude: the pole ghost is the ring at lon + pi (sign +1)
  const T p_s = j == 0 ? p(g.cell(i, 0, g.antipode(k)))
                       : p(g.cell(i, j - 1, k));
  const T p_n = j + 1 < g.nlat ? p(g.cell(i, j + 1, k))
                               : p(g.cell(i, g.nlat - 1, g.antipode(k)));
  const T gl_lo = (pc - p_s) / m(C_DLAT_LO);
  const T gl_hi = (p_n - pc) / m(C_DLAT_HI);
  // longitude: periodic
  const T go_lo = (pc - p(g.cell(i, j, g.wrap(k - 1)))) / m(C_DLON);
  const T go_hi = (p(g.cell(i, j, g.wrap(k + 1))) - pc) / m(C_DLON);

  // left faces: the radial wall face and the pole face carry no flow
  f0[c] = narrow<S>(i == 0 ? T(0) : widen(uf0[c]) - dt * gr_lo);
  f1[c] = narrow<S>(j == 0 ? T(0) : widen(uf1[c]) - dt * gl_lo);
  f2[c] = narrow<S>(widen(uf2[c]) - dt * go_lo);
  // cell velocity: centred gradient = mean of the two face gradients
  u_new[c] = narrow<S>(widen(u_star[c]) - dt * (T(0.5) * (gr_lo + gr_hi)));
  u_new[N + c] =
      narrow<S>(widen(u_star[N + c]) - dt * (T(0.5) * (gl_lo + gl_hi)));
  u_new[2 * N + c] =
      narrow<S>(widen(u_star[2 * N + c]) - dt * (T(0.5) * (go_lo + go_hi)));
  p_new[c] = narrow<S>(incremental ? widen(pres[c]) + pc : pc);
}

template <typename S, typename T = shell::compute_t<S>>
int launch_correct(int nr, int nlat, int nlon, const T* M, const S* u_star,
                   const S* phi, const S* uf0, const S* uf1, const S* uf2,
                   const S* pres, const S* phi_mean, double dt,
                   int incremental, S* u_new, S* f0, S* f1, S* f2, S* p_new,
                   void* stream) {
  Dims g{nr, nlat, nlon};
  const int64_t N = (int64_t)nr * nlat * nlon;
  const unsigned grid = (unsigned)((N + BLOCK - 1) / BLOCK);
  correct_kernel<S><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      g, M, u_star, phi, uf0, uf1, uf2, pres, phi_mean, T(dt), incremental,
      u_new, f0, f1, f2, p_new);
  return (int)cudaGetLastError();
}

}  // namespace

// S: the fields' storage type, T: the compute type of the metric and the
// sums
#define PROJECTION_ENTRY(NAME, S, T)                                        \
  extern "C" int NAME(int nr, int nlat, int nlon, const T* M,               \
                      const S* u_star, double dt, S* f0, S* f1, S* f2,      \
                      S* rhs_raw, T* parts, T* sums, void* stream) {        \
    return launch<S>(nr, nlat, nlon, M, u_star, dt, f0, f1, f2, rhs_raw,    \
                     parts, sums, stream);                                  \
  }

PROJECTION_ENTRY(dp_faces_div_f32, float, float)
PROJECTION_ENTRY(dp_faces_div_f64, double, double)
PROJECTION_ENTRY(dp_faces_div_bf16, __nv_bfloat16, float)

#define CORRECT_ENTRY(NAME, S, T)                                           \
  extern "C" int NAME(int nr, int nlat, int nlon, const T* M,               \
                      const S* u_star, const S* phi, const S* uf0,          \
                      const S* uf1, const S* uf2, const S* pres,            \
                      const S* phi_mean, double dt, int incremental,        \
                      S* u_new, S* f0, S* f1, S* f2, S* p_new,              \
                      void* stream) {                                       \
    return launch_correct<S>(nr, nlat, nlon, M, u_star, phi, uf0, uf1, uf2, \
                             pres, phi_mean, dt, incremental, u_new, f0,    \
                             f1, f2, p_new, stream);                        \
  }

CORRECT_ENTRY(dp_correct_f32, float, float)
CORRECT_ENTRY(dp_correct_f64, double, double)
CORRECT_ENTRY(dp_correct_bf16, __nv_bfloat16, float)
