// K4: batched tridiagonal solve (Thomas algorithm, no pivoting) along
// axis 0: m independent systems of size n, each operand read as the
// caller passes it.
//
// Replaces the Pallas kernel tridiag_pallas
// (dycoreplanet_tpu/ops/pallas_kernels.py:59, body _tridiag_kernel :30),
// which DMAs an (n, 128-lane) slab of every operand, broadcast and
// padded to (n, m), into VMEM and runs both recurrences there. The
// direct Helmholtz solves of the shell call it twice a step: n = nr = 32
// radial levels, m = C * nlat * 2 * (nlon/2 + 1) systems (99 072 for the
// momentum stack, 33 024 for temperature, at 32x128x256). The multigrid
// line smoother of `poisson solver = mg` calls it ~104 times a V-cycle:
// lower and upper vary per column there, and the rhs is a moved-axis
// view of the residual, or on a periodic axis the Sherman-Morrison pair
// [r, u] stacked on axis 1 (a batch axis, not the pair axis: its lower
// and upper are not row-only).
//
// Bound: device-memory traffic. Each operand is read once as passed and
// x written once: on the direct path lower and upper are one value a
// row, diag is broadcast over the real/imaginary axis, so rhs + x + diag
// + 2n values (31.7 MB for the momentum stack in f32) against ~8
// operations per value. What held the one-thread-per-system design back
// was latency, not bandwidth: each row's loads sat inside the dependent
// chain of divisions.
//
// Layout: an operand is its base pointer, a row stride and the strides
// of three column axes (C order, stride 0 where it is broadcast), plus
// the stride of an optional pair axis (ops/tridiag.py `layout`). A
// thread owns one column: P = 1 system, or P = 2 systems along the pair
// axis, an axis of size 2 along which lower, diag and upper all have
// stride 0 (the real/imaginary axis of the direct solves).
//
// Design (thomas_staged, while a block's slab fits in shared memory):
//   * stage, then recur: a block of W threads owns W consecutive
//     columns. Each thread first starts cp.async copies of all n rows of
//     its rhs values and of diag into shared memory ([row][thread], so
//     a warp's accesses are consecutive); lower and upper, when they
//     vary along rows only (ROWC), are copied once a block. Only then
//     does it wait, and the recurrences read rows already on chip. The
//     copies are 4-byte (8 in f64) ones: 16-byte copies need 16-byte-
//     aligned runs, and the bench's innermost axis holds 129 values.
//     TMA would need tensor maps (cuTensorMapEncodeTiled) and 16-byte-
//     aligned strides, which the operands as passed do not have.
//     Staging in registers instead left the loads to the compiler's
//     scheduler, which sank them into the chain of divisions (PERF.md,
//     K4);
//   * P = 2 factors once for the pair: r_i = 1 / (d_i - l_i c'_{i-1})
//     and c'_i = u_i r_i are formed once, both right-hand sides use
//     multiplies only (one division a row for two systems instead of
//     four). P = 1 keeps the plain version's divisions;
//   * g_i overwrites b_i and c'_i overwrites d_i in shared memory; the
//     back substitution writes x row by row, coalesced along the
//     innermost axis.
// thomas_general (n too large for shared memory): a thread a column,
// loads inside the chain, c' in a scratch of (n, columns) from the
// wrapper, g in x and then x back-substituted in place.
// Neither reads lower[0] nor upper[n-1]: the first row divides by d_0
// alone and the last c' is never formed.
//
// Storage and compute (shell_common.cuh): the float and double forms
// read and write their own type; the bfloat16 form (the multigrid line
// smoother of a bfloat16 model, whose residual lines are bfloat16) reads
// rhs as bfloat16, widening each value as it stages or loads it, and
// lower, diag and upper in float (the smoother's tables: bfloat16
// coefficients ruin its nearly singular lon lines), runs both
// recurrences in float and writes x (and c' in the scratch) in float, as
// the plain version returns them.
#include <stddef.h>
#include <stdint.h>

#include "shell_common.cuh"

namespace {

using shell::compute_t;
using shell::widen;

constexpr int MAX_BLOCK = 256;
// the most shared memory one block may use on an H100
constexpr size_t SMEM_MAX = 232448;

// element (i, i0, i1, i2, p) at p + i*row + i0*s[0] + i1*s[1] + i2*s[2]
// + p*pair
template <typename T>
struct Operand {
  T* p;
  int64_t row;
  int64_t s[3];
  int64_t pair;
};

// S: rhs's storage type; the coefficients and x are in its compute type
template <typename S>
struct Args {
  int n;
  uint32_t cols;     // columns: systems / P
  uint32_t n1, n2;   // sizes of column axes 1 and 2 (axis 0: the rest)
  Operand<compute_t<S>> l, d, u, x;
  Operand<S> b;
};

template <typename T>
__device__ __forceinline__ int64_t col_offset(const Operand<T>& o,
                                              uint32_t i0, uint32_t i1,
                                              uint32_t i2) {
  return (int64_t)i0 * o.s[0] + (int64_t)i1 * o.s[1] + (int64_t)i2 * o.s[2];
}

// shared memory of a staged block (in the compute type T): per thread
// the P rhs columns, diag and (unless ROWC) lower and upper; with ROWC one
// lower and one upper row for the block
template <typename T>
size_t staged_bytes(int n, int pair, bool rowc, int block) {
  return (size_t)n * sizeof(T) *
         ((size_t)block * (pair + 1 + (rowc ? 0 : 2)) + (rowc ? 2 : 0));
}

template <typename T>
int staged_max(int pair, bool rowc, int block) {
  return (int)(SMEM_MAX / staged_bytes<T>(1, pair, rowc, block));
}

template <typename T>
__device__ __forceinline__ void copy_async(T* smem, const T* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(sizeof(T)));
}
// a bfloat16 value widened into shared memory (a register round trip)
__device__ __forceinline__ void copy_async(float* smem,
                                           const __nv_bfloat16* gmem) {
  *smem = __bfloat162float(*gmem);
}

template <typename S, int P, bool ROWC>
__global__ void __launch_bounds__(MAX_BLOCK)
    thomas_staged(const Args<S> a) {
  using T = compute_t<S>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, W = blockDim.x, t = threadIdx.x;
  // [P][n][W] rhs, then g; [n][W] diag, then c'; lower and upper:
  // [n] each (ROWC) or [n][W] each
  T* sb = reinterpret_cast<T*>(smem_raw);
  T* sd = sb + (size_t)P * n * W;
  T* sl = sd + (size_t)n * W;
  T* su = sl + (ROWC ? n : (size_t)n * W);
  const int ls = ROWC ? 1 : W;   // row stride of sl, su
  const int lt = ROWC ? 0 : t;   // this thread's column in them

  if constexpr (ROWC) {
    for (int i = t; i < n; i += W) {
      if (i > 0) copy_async(sl + i, a.l.p + i * a.l.row);
      if (i + 1 < n) copy_async(su + i, a.u.p + i * a.u.row);
    }
  }
  const uint32_t col = blockIdx.x * W + t;
  const bool live = col < a.cols;
  uint32_t i0 = 0, i1 = 0, i2 = 0;
  if (live) {
    i2 = col % a.n2;
    const uint32_t rest = col / a.n2;
    i1 = rest % a.n1;
    i0 = rest / a.n1;
    const T* D = a.d.p + col_offset(a.d, i0, i1, i2);
    const S* B = a.b.p + col_offset(a.b, i0, i1, i2);
    for (int i = 0; i < n; ++i) {
      copy_async(sd + i * W + t, D + i * a.d.row);
#pragma unroll
      for (int p = 0; p < P; ++p)
        copy_async(sb + (p * n + i) * W + t, B + i * a.b.row + p * a.b.pair);
    }
    if constexpr (!ROWC) {
      const T* L = a.l.p + col_offset(a.l, i0, i1, i2);
      const T* U = a.u.p + col_offset(a.u, i0, i1, i2);
      for (int i = 0; i < n; ++i) {
        if (i > 0) copy_async(sl + i * W + t, L + i * a.l.row);
        if (i + 1 < n) copy_async(su + i * W + t, U + i * a.u.row);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  if (!live) return;

  // forward sweep: c'_i = u_i / (d_i - l_i c'_{i-1}),
  //                g_i  = (b_i - l_i g_{i-1}) / (d_i - l_i c'_{i-1});
  // row 0 takes l_0 = c'_{-1} = g_{-1} = 0 without reading lower[0]
  T cp = T(0), gp[P];
#pragma unroll
  for (int p = 0; p < P; ++p) gp[p] = T(0);
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    const T li = i > 0 ? sl[i * ls + lt] : T(0);
    const T ui = i + 1 < n ? su[i * ls + lt] : T(0);
    const T den = sd[i * W + t] - li * cp;
    if constexpr (P == 1) {
      cp = ui / den;
      gp[0] = (sb[i * W + t] - li * gp[0]) / den;
    } else {
      const T r = T(1) / den;
      cp = ui * r;
#pragma unroll
      for (int p = 0; p < P; ++p)
        gp[p] = (sb[(p * n + i) * W + t] - li * gp[p]) * r;
    }
    sd[i * W + t] = cp;
#pragma unroll
    for (int p = 0; p < P; ++p) sb[(p * n + i) * W + t] = gp[p];
  }

  // back substitution: x_{n-1} = g_{n-1}, x_i = g_i - c'_i x_{i+1}
  T* X = a.x.p + col_offset(a.x, i0, i1, i2);
#pragma unroll
  for (int p = 0; p < P; ++p) X[(n - 1) * a.x.row + p * a.x.pair] = gp[p];
#pragma unroll 4
  for (int i = n - 2; i >= 0; --i) {
    const T ci = sd[i * W + t];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      gp[p] = sb[(p * n + i) * W + t] - ci * gp[p];
      X[i * a.x.row + p * a.x.pair] = gp[p];
    }
  }
}

template <typename S, int P>
__global__ void __launch_bounds__(MAX_BLOCK)
    thomas_general(const Args<S> a, compute_t<S>* __restrict__ cs) {
  using T = compute_t<S>;
  const uint32_t col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= a.cols) return;
  const uint32_t i2 = col % a.n2, rest = col / a.n2;
  const uint32_t i1 = rest % a.n1, i0 = rest / a.n1;
  const T* L = a.l.p + col_offset(a.l, i0, i1, i2);
  const T* D = a.d.p + col_offset(a.d, i0, i1, i2);
  const T* U = a.u.p + col_offset(a.u, i0, i1, i2);
  const S* B = a.b.p + col_offset(a.b, i0, i1, i2);
  T* X = a.x.p + col_offset(a.x, i0, i1, i2);
  const int64_t rl = a.l.row, rd = a.d.row, ru = a.u.row, rb = a.b.row,
                rx = a.x.row, pb = a.b.pair, px = a.x.pair, m = a.cols;
  const int n = a.n;
  cs += col;
  T cp = T(0), gp[P];
#pragma unroll
  for (int p = 0; p < P; ++p) gp[p] = T(0);
  for (int i = 0; i < n; ++i) {
    const T li = i > 0 ? L[i * rl] : T(0);
    const T ui = i + 1 < n ? U[i * ru] : T(0);
    const T den = D[i * rd] - li * cp;
    if constexpr (P == 1) {
      cp = ui / den;
      gp[0] = (widen(B[i * rb]) - li * gp[0]) / den;
    } else {
      const T r = T(1) / den;
      cp = ui * r;
#pragma unroll
      for (int p = 0; p < P; ++p)
        gp[p] = (widen(B[i * rb + p * pb]) - li * gp[p]) * r;
    }
    cs[i * m] = cp;
#pragma unroll
    for (int p = 0; p < P; ++p) X[i * rx + p * px] = gp[p];
  }
  // x_{n-1} = g_{n-1}, already stored
  for (int i = n - 2; i >= 0; --i) {
    const T ci = cs[i * m];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      gp[p] = X[i * rx + p * px] - ci * gp[p];
      X[i * rx + p * px] = gp[p];
    }
  }
}

// the staged kernel of a launch (P, ROWC), its dynamic shared memory
// limit raised to SMEM_MAX and the SM's carveout set to shared memory
template <typename S>
const void* staged_kernel(int pair, bool rowc) {
  const void* f = pair == 2 ? (const void*)thomas_staged<S, 2, true>
                  : rowc    ? (const void*)thomas_staged<S, 1, true>
                            : (const void*)thomas_staged<S, 1, false>;
  static bool sized[3] = {false, false, false};
  const int k = pair == 2 ? 0 : rowc ? 1 : 2;
  if (!sized[k] &&
      cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)SMEM_MAX) == cudaSuccess &&
      cudaFuncSetAttribute(f, cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared) == cudaSuccess)
    sized[k] = true;
  return f;
}

template <typename T>
bool row_only(const Operand<T>& o) {
  return o.s[0] == 0 && o.s[1] == 0 && o.s[2] == 0 && o.pair == 0;
}

// sizes: the three column axes (C order); desc: for lower, diag, upper,
// rhs, x in turn, the row stride, the three column strides and the pair
// stride (elements)
template <typename S, typename T = compute_t<S>>
int launch(int n, int64_t cols, int pair, int block, const int64_t* sizes,
           const int64_t* desc, const T* l, const T* d, const T* u,
           const S* b, T* x, T* scratch, void* stream) {
  if (n < 1 || cols < 1 || cols > INT32_MAX || (pair != 1 && pair != 2) ||
      block < 32 || block > MAX_BLOCK || block % 32 != 0 ||
      sizes[1] < 1 || sizes[2] < 1 || sizes[0] * sizes[1] * sizes[2] != cols)
    return (int)cudaErrorInvalidValue;
  Args<S> a;
  a.n = n;
  a.cols = (uint32_t)cols;
  a.n1 = (uint32_t)sizes[1];
  a.n2 = (uint32_t)sizes[2];
  auto describe = [&](auto& op, auto* ptr, int k) {
    op.p = ptr;
    op.row = desc[5 * k];
    for (int j = 0; j < 3; ++j) op.s[j] = desc[5 * k + 1 + j];
    op.pair = desc[5 * k + 4];
  };
  describe(a.l, const_cast<T*>(l), 0);
  describe(a.d, const_cast<T*>(d), 1);
  describe(a.u, const_cast<T*>(u), 2);
  describe(a.b, const_cast<S*>(b), 3);
  describe(a.x, x, 4);
  const bool rowc = row_only(a.l) && row_only(a.u);
  // the pair shares lower, diag and upper
  if (pair == 2 && !(rowc && a.d.pair == 0)) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((cols + block - 1) / block);
  cudaStream_t s = (cudaStream_t)stream;
  void* args[] = {&a};
  if (n <= staged_max<T>(pair, rowc, block)) {
    const cudaError_t e = cudaLaunchKernel(
        staged_kernel<S>(pair, rowc), dim3(grid), dim3(block), args,
        staged_bytes<T>(n, pair, rowc, block), s);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (pair == 2)
    thomas_general<S, 2><<<grid, block, 0, s>>>(a, scratch);
  else
    thomas_general<S, 1><<<grid, block, 0, s>>>(a, scratch);
  return (int)cudaGetLastError();
}

// resident blocks an SM of the kernel a launch with these arguments
// takes (its dynamic shared memory included)
template <typename S, typename T = compute_t<S>>
int occupancy(int n, int pair, bool rowc, int block, int* blocks) {
  if (n <= staged_max<T>(pair, rowc, block))
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, staged_kernel<S>(pair, rowc), block,
        staged_bytes<T>(n, pair, rowc, block));
  const void* f = pair == 2 ? (const void*)thomas_general<S, 2>
                            : (const void*)thomas_general<S, 1>;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, f, block,
                                                            0);
}

}  // namespace

// NAME: the solve; scratch is (n, columns) for c' where n exceeds
// NAME_staged_max, else unused. NAME_staged_max: the most rows a block
// of `block` threads stages in shared memory. NAME_occupancy: resident
// blocks an SM of the kernel that a launch with these arguments takes.
// S: rhs's storage type, T: the compute type of the coefficients, x and
// the scratch
#define TRIDIAG_ENTRY(NAME, S, T)                                            \
  extern "C" int NAME(int n, int64_t cols, int pair, int block,              \
                      const int64_t* sizes, const int64_t* desc, const T* l, \
                      const T* d, const T* u, const S* b, T* x, T* scratch,  \
                      void* stream) {                                        \
    return launch<S>(n, cols, pair, block, sizes, desc, l, d, u, b, x,       \
                     scratch, stream);                                       \
  }                                                                          \
  extern "C" int NAME##_staged_max(int pair, int rowc, int block) {          \
    return staged_max<T>(pair, rowc != 0, block);                            \
  }                                                                          \
  extern "C" int NAME##_occupancy(int n, int pair, int rowc, int block,      \
                                  int* blocks) {                             \
    return occupancy<S>(n, pair, rowc != 0, block, blocks);                  \
  }

TRIDIAG_ENTRY(dp_tridiag_f32, float, float)
TRIDIAG_ENTRY(dp_tridiag_f64, double, double)
TRIDIAG_ENTRY(dp_tridiag_bf16, __nv_bfloat16, float)
