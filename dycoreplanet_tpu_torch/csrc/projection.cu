// K3: the pre-Poisson projection head on its own — the steps that
// bypass the Richardson kernel (escalated, full-CG steps) still take it.
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
#include "shell_common.cuh"

namespace {

using shell::Dims;

constexpr int BLOCK = 256;

// metric channels at (i, j)
enum { M_VOL = 0, M_AR_LO, M_AR_HI, M_ALAT_LO, M_ALAT_HI, M_ALON, M_K };

template <typename T>
__global__ void faces_div_kernel(Dims g, const T* __restrict__ M,
                                 const T* __restrict__ u_star, T dt,
                                 T* __restrict__ f0, T* __restrict__ f1,
                                 T* __restrict__ f2, T* __restrict__ rhs_raw,
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
    shell::faces_div_cell<T>(g, u_star, M, hm, i, j, k, dt, a0, a1, a2, rhs);
    f0[c] = a0;
    f1[c] = a1;
    f2[c] = a2;
    rhs_raw[c] = rhs;
    s = rhs;
  }
  shell::block_sum<T, BLOCK>(s, parts, 1, 0);
}

template <typename T>
int launch(int nr, int nlat, int nlon, const T* M, const T* u_star,
           double dt, T* f0, T* f1, T* f2, T* rhs_raw, T* parts, T* sums,
           void* stream) {
  Dims g{nr, nlat, nlon};
  const int64_t N = (int64_t)nr * nlat * nlon;
  const unsigned grid = (unsigned)((N + BLOCK - 1) / BLOCK);
  cudaStream_t s = (cudaStream_t)stream;
  faces_div_kernel<T><<<grid, BLOCK, 0, s>>>(g, M, u_star, T(dt), f0, f1, f2,
                                             rhs_raw, parts);
  int err = (int)cudaGetLastError();
  if (err) return err;
  shell::reduce_partials<T, BLOCK><<<1, BLOCK, 0, s>>>(parts, (int)grid, 1,
                                                       sums);
  return (int)cudaGetLastError();
}

}  // namespace

#define PROJECTION_ENTRY(NAME, T)                                           \
  extern "C" int NAME(int nr, int nlat, int nlon, const T* M,               \
                      const T* u_star, double dt, T* f0, T* f1, T* f2,      \
                      T* rhs_raw, T* parts, T* sums, void* stream) {        \
    return launch<T>(nr, nlat, nlon, M, u_star, dt, f0, f1, f2, rhs_raw,    \
                     parts, sums, stream);                                  \
  }

PROJECTION_ENTRY(dp_faces_div_f32, float)
PROJECTION_ENTRY(dp_faces_div_f64, double)
