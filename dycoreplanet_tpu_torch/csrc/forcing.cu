// K2: explicit forcing of the shell standard (advective) personality,
// with the temperature transport fused in the same pass.
//
// Replaces the Pallas kernel ShellForcingPallas._build_call
// (dycoreplanet_tpu/ops/pallas_stencil.py:373). Computes, per cell,
//
//   rhs_u = u + dt * ( -(adv(u) + curv(u)) + cor(u) + buoy(T)
//                      + visc_curv(u) / Re - grad p )
//   T_adv = T - dt_T * (div(u_f T) - T div(u_f))
//
// with MUSCL (van Leer) / upwind / centred face reconstruction, the
// ghost rules of ops/bc.py and a Dirichlet inner wall for T.
//
// Bound: device-memory traffic. It reads u (3 fields), the three face
// velocities, T and p, and writes rhs_u (3) and T_adv: 12 fields of
// nr*nlat*nlon values (~50 MB at 32x128x256 f32), against roughly
// 480 floating-point operations per cell.
//
// Design: one thread per cell, longitude fastest so that neighbouring
// threads read neighbouring addresses. Every ghost (periodic lon wrap,
// pole ring at lon + pi, radial wall mirror) is index arithmetic on a
// global load; the stencil's repeated reads of a neighbour hit L1/L2.
// Metrics are lon-invariant (K, nr, nlat) channels. No shared memory,
// no reductions. A tiled version that stages planes in shared memory is
// later work.
#include "shell_common.cuh"

namespace {

using shell::Dims;
using shell::Ref;

// metric channels at (i, j)
enum {
  M_VOL = 0, M_AR_LO, M_AR_HI, M_ALAT_LO, M_ALAT_HI, M_ALON,
  M_DR_LO, M_DR_HI, M_DLAT_LO, M_DLAT_HI, M_DLON, M_RC, M_GR, M_K
};

template <typename T>
struct Rules {
  int lo, hi;        // radial ghost rules
  float pole;        // +1 POLE, -1 POLE_FLIP
  const T* wall;     // (nlat, nlon) wall values for a DIRICHLET lo wall
};

template <typename T>
__device__ __forceinline__ T get_r(const Dims& g, const T* F, const Rules<T>& R,
                                   int m, int j, int k) {
  Ref r = shell::ref_r(g, m, j, k, R.lo, R.hi);
  T v = F[r.idx];
  if (m < 0 && R.lo == shell::DIRICHLET)
    return T(2) * R.wall[(int64_t)j * g.nlon + k] - v;
  return T(r.sign) * v;
}

template <typename T>
__device__ __forceinline__ T get_lat(const Dims& g, const T* F,
                                     const Rules<T>& R, int i, int m, int k) {
  Ref r = shell::ref_lat(g, i, m, k, R.pole);
  return T(r.sign) * F[r.idx];
}

// sum over the three axes of [A u_f q]_out - [A u_f q]_in (not yet / vol)
template <typename T>
__device__ T advective_flux_sum(const Dims& g, const T* F, const Rules<T>& R,
                                const T* f0, const T* f1, const T* f2,
                                const T* M, int i, int j, int k, int scheme) {
  const int64_t MS = (int64_t)g.nr * g.nlat;
  const int mi = g.lm(i, j);
  auto m = [&](int ch) { return M[ch * MS + mi]; };
  const int64_t c = g.cell(i, j, k);

  auto gr = [&](int q) { return get_r<T>(g, F, R, q, j, k); };
  T aq_lo = m(M_AR_LO) * (f0[c] * shell::face_value<T>(gr, i, g.nr, false,
                                                        f0[c], scheme));
  T aq_up = T(0);
  if (i + 1 < g.nr) {
    T uf = f0[g.cell(i + 1, j, k)];
    aq_up = m(M_AR_HI) * (uf * shell::face_value<T>(gr, i + 1, g.nr, false,
                                                      uf, scheme));
  }
  T acc = aq_up - aq_lo;

  auto gl = [&](int q) { return get_lat<T>(g, F, R, i, q, k); };
  aq_lo = m(M_ALAT_LO) * (f1[c] * shell::face_value<T>(gl, j, g.nlat, false,
                                                        f1[c], scheme));
  aq_up = T(0);
  if (j + 1 < g.nlat) {
    T uf = f1[g.cell(i, j + 1, k)];
    aq_up = m(M_ALAT_HI) * (uf * shell::face_value<T>(gl, j + 1, g.nlat,
                                                        false, uf, scheme));
  }
  acc = acc + (aq_up - aq_lo);

  auto go = [&](int q) { return F[g.cell(i, j, g.wrap(q))]; };
  T uf_up = f2[g.cell(i, j, g.wrap(k + 1))];
  aq_lo = m(M_ALON) * (f2[c] * shell::face_value<T>(go, k, g.nlon, true,
                                                     f2[c], scheme));
  aq_up = m(M_ALON) * (uf_up * shell::face_value<T>(go, k + 1, g.nlon, true,
                                                     uf_up, scheme));
  return acc + (aq_up - aq_lo);
}

// centred gradient: mean of the two adjacent face-normal derivatives
template <typename T, typename Get>
__device__ __forceinline__ T cgrad(const Get& get, int c, T dl, T dh) {
  T v = get(c);
  T gl = (v - get(c - 1)) / dl;
  T gh = (get(c + 1) - v) / dh;
  return T(0.5) * (gl + gh);
}

template <typename T>
__global__ void forcing_kernel(
    Dims g, const T* __restrict__ u, const T* __restrict__ f0,
    const T* __restrict__ f1, const T* __restrict__ f2,
    const T* __restrict__ Tf, const T* __restrict__ p,
    const T* __restrict__ T_wall, const T* __restrict__ M,
    const T* __restrict__ lat, T dt, T dt_T, T beta, T T_ref, T rho_bg,
    T iRe, T omega, int scheme, int physical_coriolis, int perturbation,
    int include_gradp, T* __restrict__ rhs_u, T* __restrict__ T_adv) {
  const int64_t N = g.n_cells();
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= N) return;
  int i, j, k;
  g.coords(c, i, j, k);
  const int64_t MS = (int64_t)g.nr * g.nlat;
  const int mi = g.lm(i, j);
  auto m = [&](int ch) { return M[ch * MS + mi]; };
  const T cosl = lat[j], tanl = lat[g.nlat + j], sinl = lat[2 * g.nlat + j];
  const T vol = m(M_VOL), r = m(M_RC);

  // div(u_f), shared by the three momentum components and T
  T dq_r = (i + 1 < g.nr ? m(M_AR_HI) * f0[g.cell(i + 1, j, k)] : T(0))
           - m(M_AR_LO) * f0[c];
  T dq_l = (j + 1 < g.nlat ? m(M_ALAT_HI) * f1[g.cell(i, j + 1, k)] : T(0))
           - m(M_ALAT_LO) * f1[c];
  T dq_o = m(M_ALON) * f2[g.cell(i, j, g.wrap(k + 1))] - m(M_ALON) * f2[c];
  const T div_u = ((dq_r + dq_l) + dq_o) / vol;

  const T* u0 = u;
  const T* u1 = u + N;
  const T* u2 = u + 2 * N;
  const T ur = u0[c], ul = u1[c], up = u2[c];

  // ghost rules: u_r antisym/antisym + POLE; u_lat, u_lon antisym/
  // Neumann + POLE_FLIP; T Dirichlet/Neumann + POLE; p Neumann + POLE
  const Rules<T> R_ur{shell::ANTISYM, shell::ANTISYM, 1.f, nullptr};
  const Rules<T> R_ut{shell::ANTISYM, shell::NEUMANN, -1.f, nullptr};
  const Rules<T> R_T{shell::DIRICHLET, shell::NEUMANN, 1.f, T_wall};
  const Rules<T> R_p{shell::NEUMANN, shell::NEUMANN, 1.f, nullptr};

  T adv[3];
  const T* comps[3] = {u0, u1, u2};
  const T uc[3] = {ur, ul, up};
  for (int q = 0; q < 3; ++q) {
    const Rules<T>& R = q == 0 ? R_ur : R_ut;
    T s = advective_flux_sum<T>(g, comps[q], R, f0, f1, f2, M, i, j, k,
                                scheme);
    adv[q] = s / vol - uc[q] * div_u;
  }
  // curvature of (u . grad) u
  adv[0] = adv[0] + (-(ul * ul + up * up) / r);
  adv[1] = adv[1] + (ur * ul / r + up * up * tanl / r);
  adv[2] = adv[2] + (ur * up / r - ul * up * tanl / r);

  // Coriolis: none on the shell in the reference mode
  T cor[3] = {T(0), T(0), T(0)};
  if (physical_coriolis) {
    T om_r = omega * sinl, om_l = omega * cosl;
    cor[0] = T(2) * om_l * up;
    cor[1] = T(-2) * om_r * up;
    cor[2] = T(2) * (om_r * ul - om_l * ur);
  }

  // buoyancy (radial gravity only)
  T rho = T(1) - beta * (Tf[c] - T_ref);
  T buoy_r = (perturbation ? rho - rho_bg : rho) * m(M_GR);

  // explicit curvature corrections of the vector Laplacian
  const T dlat_lo = m(M_DLAT_LO), dlat_hi = m(M_DLAT_HI), dlon = m(M_DLON);
  auto lat_of = [&](const T* F, const Rules<T>& R) {
    return [=, &g, &R](int q) { return get_lat<T>(g, F, R, i, q, k); };
  };
  auto lon_of = [&](const T* F) {
    return [=, &g](int q) { return F[g.cell(i, j, g.wrap(q))]; };
  };
  T dlat_ur = cgrad<T>(lat_of(u0, R_ur), j, dlat_lo, dlat_hi);
  T dlat_ul = cgrad<T>(lat_of(u1, R_ut), j, dlat_lo, dlat_hi);
  T dlon_ur = cgrad<T>(lon_of(u0), k, dlon, dlon);
  T dlon_ul = cgrad<T>(lon_of(u1), k, dlon, dlon);
  T dlon_up = cgrad<T>(lon_of(u2), k, dlon, dlon);
  T rcos = r * cosl;
  T visc[3];
  visc[0] = T(-2) * ur / (r * r)
            - T(2) / r * (dlat_ul - ul * tanl / r + dlon_up);
  visc[1] = T(2) / r * dlat_ur - ul / (rcos * rcos)
            + T(2) * tanl / r * dlon_up;
  visc[2] = T(2) / r * dlon_ur - T(2) * tanl / r * dlon_ul
            - up / (rcos * rcos);

  T gradp[3] = {T(0), T(0), T(0)};
  if (include_gradp) {
    auto pr = [&](int q) { return get_r<T>(g, p, R_p, q, j, k); };
    gradp[0] = cgrad<T>(pr, i, m(M_DR_LO), m(M_DR_HI));
    gradp[1] = cgrad<T>(lat_of(p, R_p), j, dlat_lo, dlat_hi);
    gradp[2] = cgrad<T>(lon_of(p), k, dlon, dlon);
  }

  const T buoy[3] = {buoy_r, T(0), T(0)};
  for (int q = 0; q < 3; ++q) {
    T F = -adv[q] + cor[q] + buoy[q] + iRe * visc[q];
    if (include_gradp) F = F - gradp[q];
    rhs_u[q * N + c] = uc[q] + dt * F;
  }

  if (T_adv != nullptr) {
    T s = advective_flux_sum<T>(g, Tf, R_T, f0, f1, f2, M, i, j, k, scheme);
    T adv_T = s / vol - Tf[c] * div_u;
    T_adv[c] = Tf[c] - dt_T * adv_T;
  }
}

template <typename T>
int launch(int nr, int nlat, int nlon, const T* u, const T* f0, const T* f1,
           const T* f2, const T* Tf, const T* p, const T* T_wall, const T* M,
           const T* lat, double dt, double dt_T, double beta, double T_ref,
           double rho_bg, double iRe, double omega, int scheme,
           int physical_coriolis, int perturbation, int include_gradp,
           T* rhs_u, T* T_adv, void* stream) {
  Dims g{nr, nlat, nlon};
  const int64_t N = (int64_t)nr * nlat * nlon;
  const int block = 256;
  const unsigned grid = (unsigned)((N + block - 1) / block);
  forcing_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      g, u, f0, f1, f2, Tf, p, T_wall, M, lat, T(dt), T(dt_T), T(beta),
      T(T_ref), T(rho_bg), T(iRe), T(omega), scheme, physical_coriolis,
      perturbation, include_gradp, rhs_u, T_adv);
  return (int)cudaGetLastError();
}

}  // namespace

#define FORCING_ENTRY(NAME, T)                                              \
  extern "C" int NAME(int nr, int nlat, int nlon, const T* u, const T* f0,  \
                      const T* f1, const T* f2, const T* Tf, const T* p,    \
                      const T* T_wall, const T* M, const T* lat, double dt, \
                      double dt_T, double beta, double T_ref,               \
                      double rho_bg, double iRe, double omega, int scheme,  \
                      int physical_coriolis, int perturbation,              \
                      int include_gradp, T* rhs_u, T* T_adv,                \
                      void* stream) {                                       \
    return launch<T>(nr, nlat, nlon, u, f0, f1, f2, Tf, p, T_wall, M, lat,  \
                     dt, dt_T, beta, T_ref, rho_bg, iRe, omega, scheme,     \
                     physical_coriolis, perturbation, include_gradp,        \
                     rhs_u, T_adv, stream);                                 \
  }

FORCING_ENTRY(dp_forcing_f32, float)
FORCING_ENTRY(dp_forcing_f64, double)
