// K4: batched tridiagonal solve (Thomas algorithm, no pivoting) along
// axis 0 of (n, m) arrays: m independent systems of size n.
//
// Replaces the Pallas kernel tridiag_pallas
// (dycoreplanet_tpu/ops/pallas_kernels.py:59, body _tridiag_kernel :30),
// which keeps an (n, 128-lane) slab in VMEM and runs both recurrences
// there. The direct Helmholtz solves of the shell call it twice a step:
// n = nr = 32 radial levels, m = C * nlat * 2 * (nlon/2 + 1) systems
// (99 072 for the momentum stack, 33 024 for temperature, at
// 32x128x256).
//
// Bound: device-memory traffic. Each operand is read once as the caller
// passes it and x written once: on the direct path lower and upper are
// one value a row and diag is broadcast over the real/imaginary axis, so
// rhs + x + diag + 2n values (31.7 MB for the momentum stack in f32)
// against ~8 operations per value. The wrapper materializes the
// coefficients to (n, m), so this kernel reads 4 full arrays.
//
// Design: one thread per system, consecutive threads on consecutive
// systems, so every row's loads and stores coalesce along the batch.
//   * thomas_registers<NMAX>: for n <= NMAX the forward sweep keeps c'
//     and g in registers (fully unrolled, compile-time indices);
//   * thomas_general: any n. c'_i overwrites u_i (the wrapper's own
//     copy, read just before) and g goes to x, then x is
//     back-substituted in place.
// Neither reads lower[0] nor upper[n-1]: the first row divides by d_0
// alone and the last c' is never formed.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int REGISTER_MAX_N = 32;

template <typename T, int NMAX>
__global__ void thomas_registers(int n, int64_t m, const T* __restrict__ l,
                                 const T* __restrict__ d,
                                 const T* __restrict__ u,
                                 const T* __restrict__ b, T* __restrict__ x) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= m) return;
  T c[NMAX], g[NMAX];
  // forward sweep: c'_i = u_i / (d_i - l_i c'_{i-1}),
  //                g_i  = (b_i - l_i g_{i-1}) / (d_i - l_i c'_{i-1})
  const T d0 = d[t];
  c[0] = n > 1 ? u[t] / d0 : T(0);
  g[0] = b[t] / d0;
#pragma unroll
  for (int i = 1; i < NMAX; ++i) {
    if (i < n) {
      const int64_t o = (int64_t)i * m + t;
      const T li = l[o];
      const T den = d[o] - li * c[i - 1];
      c[i] = i + 1 < n ? u[o] / den : T(0);
      g[i] = (b[o] - li * g[i - 1]) / den;
    }
  }
  // back substitution: x_{n-1} = g_{n-1}, x_i = g_i - c'_i x_{i+1}
  T xn = T(0);
#pragma unroll
  for (int i = NMAX - 1; i >= 0; --i) {
    if (i < n) {
      xn = i + 1 < n ? g[i] - c[i] * xn : g[i];
      x[(int64_t)i * m + t] = xn;
    }
  }
}

template <typename T>
__global__ void thomas_general(int n, int64_t m, const T* __restrict__ l,
                               const T* __restrict__ d, T* __restrict__ u,
                               const T* __restrict__ b, T* __restrict__ x) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= m) return;
  const T d0 = d[t];
  T cp = n > 1 ? u[t] / d0 : T(0);
  T gp = b[t] / d0;
  u[t] = cp;
  x[t] = gp;
  for (int i = 1; i < n; ++i) {
    const int64_t o = (int64_t)i * m + t;
    const T li = l[o];
    const T den = d[o] - li * cp;
    cp = i + 1 < n ? u[o] / den : T(0);
    gp = (b[o] - li * gp) / den;
    u[o] = cp;
    x[o] = gp;
  }
  T xn = gp;  // x_{n-1} = g_{n-1}, already stored
  for (int i = n - 2; i >= 0; --i) {
    const int64_t o = (int64_t)i * m + t;
    xn = x[o] - u[o] * xn;
    x[o] = xn;
  }
}

template <typename T>
int launch(int n, int64_t m, const T* l, const T* d, T* u, const T* b, T* x,
           void* stream) {
  if (n < 1 || m < 1) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((m + BLOCK - 1) / BLOCK);
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= REGISTER_MAX_N) {
    thomas_registers<T, REGISTER_MAX_N><<<grid, BLOCK, 0, s>>>(n, m, l, d, u,
                                                               b, x);
  } else {
    thomas_general<T><<<grid, BLOCK, 0, s>>>(n, m, l, d, u, b, x);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// u: the wrapper's own (n, m) copy of upper; for n > REGISTER_MAX_N it
// is overwritten with c'
#define TRIDIAG_ENTRY(NAME, T)                                               \
  extern "C" int NAME(int n, int64_t m, const T* l, const T* d, T* u,        \
                      const T* b, T* x, void* stream) {                      \
    return launch<T>(n, m, l, d, u, b, x, stream);                           \
  }

TRIDIAG_ENTRY(dp_tridiag_f32, float)
TRIDIAG_ENTRY(dp_tridiag_f64, double)
