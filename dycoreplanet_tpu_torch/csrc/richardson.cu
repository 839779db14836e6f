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
// Bound: device-memory traffic. The least traffic for the work is the 5
// input fields (rhs_u, rhs_T, T0) read once and the 8 output fields (u*,
// T_new, three faces, rhs_raw) written once: 13 fields (~55 MB at
// 32x128x256 f32), against ~60 operations per cell per operator apply.
//
// Design: one launch per call (ops/richardson.py `plan`). A block owns an
// RB x TL x TO tile and stages its inputs on a halo of depth
// E = max(iters) + 1 in shared memory; each sweep then runs on a region
// one cell smaller (redundant recompute on a shrinking halo), so iterates
// and residuals never go to device memory:
//   * the wall rules are metric algebra (the JAX kernel's _chans64): the
//     operator is L v = sum_faces c (v_nbr - v) + Dl v with the wall-face
//     conductances c = area/dist zeroed and the ANTISYM ghost folded into
//     the per-channel diagonal Dl; the pole faces have zero area. Cells
//     beyond a wall or a pole hold 0 with all-zero tables, so the sweep
//     has no ghost branches, and 1/D comes as a table: no divides;
//   * the metric is lon-invariant: every table is (i, j) and sits in
//     shared memory once per block;
//   * the four channels are independent until the divergence, so the
//     block walks them in turn through one set of buffers, adding each
//     velocity component's face-flux difference to the divergence;
//   * every input box is staged with cp.async (no register round trip,
//     all of a thread's copies in flight at once), and the next
//     channel's x box streams in while a channel computes;
//   * the stencil loops give each thread a short segment of a row, so
//     that the row's (i, j) tables and its lon neighbours stay in
//     registers; whatever touches device memory (staging, outputs) gives
//     neighbouring lanes neighbouring cells, so that it coalesces;
//   * the five sums are per-thread, then warp shuffles and the warps'
//     partials in a fixed order, then a fixed-order second pass by the
//     last block to finish (an integer atomic counter; no float
//     atomics): bitwise reproducible.
// Iteration counts whose halo does not fit shared memory run as several
// passes (groups of sweeps); the iterates and the tracked residuals go
// through device memory between passes.
//
// TRACK = false is the residual-free variant (the JAX kernel's
// track_residual=False, pallas_richardson.py:133-142): the steps between
// two honesty checks (`residual check interval` > 1) skip each system's
// last residual update r <- r - A (r/D) and the residual sums. The
// iterates, faces and right-hand side are the tracked kernel's, the
// b-norm partials and the right-hand side total are still summed, and
// the last pass stages the smaller halo max(iters_u + 1, iters_T): u*
// needs one ring beyond the tile for the faces, T none. At (1, 1)
// iterations both stage a halo of 2, and a cell takes 4 operator applies
// (one per channel) instead of 8.
//
// OPS = true is K1o, the per-shard kernel of a run on a mesh
// (parallel/sharded_richardson.py): the Pallas kernel's "operands" halo
// mode (pallas_richardson.py:104-116, 238-313). Its inputs are one
// shard's block extended by GH = max(iters) + 1 cells on both sides of
// lat and lon, the neighbours' cells from the halo exchange (zeros past
// a pole), and its tables are the shard's lat-extended slab (ops/
// richardson.py `shard_tables`: the global tables clipped at the poles,
// the lat face areas at face nlat). So staging reads at an offset of GH
// with no wrap, and the iterate shrinks over the extended region as over
// the radial halo: cells past a pole are finite and cross no face of
// nonzero area. The outputs are the shard's owned cells and its five
// sums, which the caller adds across the mesh in a fixed order. Always
// tracked, one pass, and tiled at run time.
//
// K1o on a shard (a quarter or an eighth of the grid) is bound by the
// card's fill, not by its bytes: at K1's (8, 8, 32) tile a shard gives
// 64-128 blocks for 264 resident slots (132 SMs x 2), each walking the
// four channels in turn, so the time is one block's, whatever the
// shard's size. So:
//   * the tile comes from the shard and the card (ops/richardson.py
//     `plan_operands`: the fewest rounds of resident slots, weighted by
//     the cells of a block's boxes), down to (4, 8, 16) on a 2 x 4 shard;
//   * the boxes are staged by rows in 16-byte cp.async chunks: in the
//     operands mode a box row is contiguous and never wraps, and with
//     E = GH it starts at extended column k0 (level 0) or k0 + 1 (level
//     1), so the x box rows have a pitch rounded up to 16 bytes and the
//     level-1 rows one more value in front (column k0 at a 16-byte
//     boundary); the (i, j) tables likewise where their rows allow. Each
//     chunk chooses its row's source (the extended block, or zero past a
//     wall, a pole or the block's edge); where the operands or the row
//     length cannot be aligned (Pass::vrow / vtab false) every value goes
//     on its own.
// The four channels on the four blocks of a thread-block cluster (one
// channel a block, the divergence summed through distributed shared
// memory) lost to one block a tile at both bench shards, f32 and f64
// (PERF.md §6: scripts/probe_k1_k2.py's sweep), and is not kept.
//
// Every form comes in float, double and bfloat16 storage (S below;
// shell_common.cuh). The bfloat16 forms read rhs_u, rhs_T and T0 as
// bfloat16, widening each value as it is staged (value by value: cp.async
// cannot widen, so K1o's 16-byte rows are off for them), keep the boxes,
// the tables and every sweep in float, and round u*, T_new, the faces and
// rhs_raw once when they store them. The residual partials and sums, and
// the iterates and residuals between passes, stay float.
#include "shell_common.cuh"

namespace {

using shell::compute_t;
using shell::Dims;
using shell::narrow;
using shell::widen;
using shell::for_box;
using shell::for_rows;
using shell::stage;
using shell::stage_commit;
using shell::stage_wait;
using shell::wrap_any;

constexpr int THREADS = 256;

// channels of the (K, nr, nlat) table stack (ops/richardson.py
// `static_tables`: the first 15 in the order of the JAX kernel's _chans64)
enum {
  M_VOL = 0, M_CR_LO, M_CR_HI, M_CL_LO, M_CL_HI, M_CO,
  M_LD0, M_LD1, M_LD2, M_LD3,
  M_AR_LO, M_ALAT_LO, M_ALON, M_DL_UR, M_DL_OTH, M_AR_HI, M_ALAT_HI, M_K
};
// the per-block shared tables: the channels the kernel reads, then 1/D of
// the four channels
constexpr int S_K = 17;
__constant__ int kTableSource[13] = {
    M_VOL, M_CR_LO, M_CR_HI, M_CL_LO, M_CL_HI, M_CO, M_DL_UR, M_DL_OTH,
    M_AR_LO, M_AR_HI, M_ALAT_LO, M_ALAT_HI, M_ALON};
enum {
  S_VOL = 0, S_CR_LO, S_CR_HI, S_CL_LO, S_CL_HI, S_CO, S_DL_UR, S_DL_OTH,
  S_AR_LO, S_AR_HI, S_ALAT_LO, S_ALAT_HI, S_ALON, S_INVD
};

// S: the fields' storage type; T, the compute type, that of the tables,
// the scratch between passes and the sums
template <typename S, typename T = compute_t<S>>
struct Pass {
  Dims g;
  int RB, TL, TO, E;       // tile and halo depth
  int nbo, nbl;            // tiles along lon and lat
  const T* M;              // (M_K, nr, nlat)
  const T* invD;           // (4, nr, nlat): 1 / (vol + coef Ld)
  const S* xu0;            // (3, N) x0 = rhs_u on the first pass, else null
  const S* xT0;            // (N) T0 on the first pass, else null
  const T* xu_in;          // (3, N) iterate of the previous pass, else null
  const T* xT_in;          // (N)
  const S* rhs_u;          // b_u = vol * rhs_u
  const S* rhs_T;          // b_T = rhs_T
  const T* ru_in;          // (3, N) residual of the previous pass, or null:
  const T* rT_in;          //   r = b - A x0 (the first pass)
  T* ru_out;               // (3, N) / (N): residual for the next pass
  T* rT_out;
  int n_u, n_T;            // sweeps of this pass
  int last;                // emit the head and the sums
  T coef_u, coef_T, dt;
  S* xu_out;               // the last pass's iterates (u*, T_new)
  S* xT_out;
  T* xu_scr;               // another pass's, for the next
  T* xT_scr;
  S* f0;
  S* f1;
  S* f2;
  S* rhs_raw;
  T* parts;                // (gridDim.x, 5)
  unsigned* counter;       // zero between calls
  T* sums;                 // (5)
  // the inputs' lat and lon extents and the ghost depth (K1: nlat, nlon,
  // 0); the grid's first row in the global grid and the global nlat (K1:
  // 0, nlat)
  int eL, eO, GH, j_off, nlat_glob;
  // K1o: the boxes' rows (vrow) and the tables' rows (vtab) go as 16-byte
  // copies
  int vrow, vtab;
};

constexpr int WARPS = THREADS / 32;

// fixed-order sum over a warp (lane 0 gets it)
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// fixed-order totals over the block of five per-thread values (valid in
// thread 0): warp sums, then warp 0 over the warps' partials
template <typename T>
__device__ __forceinline__ void block_sum5(T& a, T& b, T& c, T& d, T& e,
                                           T* red) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  a = warp_sum(a);
  b = warp_sum(b);
  c = warp_sum(c);
  d = warp_sum(d);
  e = warp_sum(e);
  if (l == 0) {
    red[w] = a;
    red[WARPS + w] = b;
    red[2 * WARPS + w] = c;
    red[3 * WARPS + w] = d;
    red[4 * WARPS + w] = e;
  }
  __syncthreads();
  if (w == 0) {
    a = warp_sum(l < WARPS ? red[l] : T(0));
    b = warp_sum(l < WARPS ? red[WARPS + l] : T(0));
    c = warp_sum(l < WARPS ? red[2 * WARPS + l] : T(0));
    d = warp_sum(l < WARPS ? red[3 * WARPS + l] : T(0));
    e = warp_sum(l < WARPS ? red[4 * WARPS + l] : T(0));
  }
  __syncthreads();
}

// kRB, kTL, kTO, kE: the tile and halo as compile-time constants (the
// bench's plan, so that box strides and divisions fold), or 0 to take
// them from the pass at run time (every other plan). TRACK: the exactly
// tracked residuals, or the residual-free variant (see the top). OPS:
// K1o
template <typename S, int kRB, int kTL, int kTO, int kE, bool TRACK, bool OPS>
__global__ void __launch_bounds__(THREADS, 2) rich_fused(const Pass<S> P) {
  using T = compute_t<S>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ bool is_last;
  PROBE_START;
  const Dims& g = P.g;
  const int64_t N = g.n_cells();
  // the inputs' component stride, and the tables' rows (K1: N, nlat)
  const int64_t NI = (int64_t)g.nr * P.eL * P.eO;
  const int TR = OPS ? P.eL : g.nlat;
  const int RB = kRB ? kRB : P.RB, TL = kTL ? kTL : P.TL;
  const int TO = kTO ? kTO : P.TO, E = kE ? kE : P.E;
  int blk = blockIdx.x;
  const int bo = blk % P.nbo;
  blk /= P.nbo;
  const int bl = blk % P.nbl, br = blk / P.nbl;
  const int i0 = br * RB, j0 = bl * TL, k0 = bo * TO;
  // level 0 (the x box, halo E) and level 1 (the r / dx boxes, halo E-1)
  const int XA = RB + 2 * E, XB = TL + 2 * E, XC = TO + 2 * E;
  const int RA = XA - 2, RBx = XB - 2, RC = XC - 2;
  // row pitches: K1o's x rows rounded up to 16 bytes, its level-1 rows
  // one value more in front (L1), so that extended column k0 starts each
  // row on a 16-byte boundary (see the top); K1's the boxes' widths
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int L1 = OPS ? 1 : 0;
  const int XP = OPS ? (XC + V - 1) / V * V : XC;
  const int RP = OPS ? (RC + V) / V * V : RC;
  const int nX = XA * XB * XP, nR = RA * RBx * RP;
  const int nTile = RB * TL * TO, nTab = XA * XB;
  // two x boxes: channel q + 1's is staged while channel q computes
  T* sxb = reinterpret_cast<T*>(smem_raw);
  T* sr_raw = sxb + 2 * nX;
  T* sdx_raw = sr_raw + nR;
  T* sdiv = sdx_raw + nR;
  T* stab = sdiv + (OPS ? (nTile + V - 1) / V * V : nTile);
  T* sred = stab + S_K * nTab;
  T* sr = sr_raw + L1;
  T* sdx = sdx_raw + L1;
  const int64_t MS = (int64_t)g.nr * TR;
  // the input row (i, j, 0) of box row (a, b) at halo h, or -1 beyond a
  // wall or a pole (K1o: beyond the extended block)
  auto row_of = [&](int a, int b, int h) -> int64_t {
    const int gi = i0 - h + a, gj = j0 - h + b;
    if (gi < 0 || gi >= g.nr) return -1;
    if (OPS) {
      const int ej = gj + P.GH;
      return ej < 0 || ej >= P.eL ? -1 : ((int64_t)gi * P.eL + ej) * P.eO;
    }
    return gj < 0 || gj >= g.nlat ? -1 : g.cell(gi, gj, 0);
  };
  // stage an nA x nB x nC box of `src` at halo h into dst, row (a, b) at
  // (a nB + b) pitch + lead: rows beyond a wall or a pole are zero,
  // longitude wraps (K1o: the extended block holds the neighbours'
  // columns); neighbouring lanes copy neighbouring cells, so each copy
  // instruction coalesces. K1o with vrow: whole rows of `pitch` values
  // from extended column k0 (E = GH) in 16-byte chunks, each zero past
  // the block's edge (eO a multiple of V: a chunk lies wholly in or out)
  // (src: storage or compute type; vrow is set only where they agree)
  auto stage_box = [&](T* dst, const auto* src, int nA, int nB, int nC,
                       int pitch, int lead, int h) {
    using Src = std::remove_cv_t<std::remove_pointer_t<decltype(src)>>;
    if constexpr (std::is_same_v<Src, T>) {
      if (OPS && P.vrow) {
        for_box<THREADS>(nA, nB, pitch / V, [&](int a, int b, int j) {
          const int64_t row = row_of(a, b, h);
          const int ec = k0 + j * V;
          const bool in = row >= 0 && ec < P.eO;
          shell::stage16(dst + (a * nB + b) * pitch + j * V,
                         src + (in ? row + ec : 0), in);
        });
        return;
      }
    }
    for_box<THREADS>(nA, nB, nC, [&](int a, int b, int c) {
      const int64_t row = row_of(a, b, h);
      const int ec = k0 - h + c + P.GH;
      const bool in = row >= 0 && (!OPS || (ec >= 0 && ec < P.eO));
      stage(dst + (a * nB + b) * pitch + lead + c,
            src + (in ? row + (OPS ? ec : wrap_any(k0 - h + c, g.nlon)) : 0),
            in);
    });
  };
  // is tile row (a, b) in the grid, and its cell c
  auto own_row = [&](int a, int b) {
    return a >= 0 && a < RB && b >= 0 && b < TL && i0 + a < g.nr &&
           j0 + b < g.nlat;
  };
  auto own_col = [&](int c) { return c >= 0 && c < TO && k0 + c < g.nlon; };

  // tables of the (i, j) box, zero beyond the walls and the poles (K1o:
  // beyond the walls and the shard's slab). K1o with vtab: rows of XB
  // values from extended row j0 (E = GH) in 16-byte chunks
  if (OPS && P.vtab) {
    for_box<THREADS>(S_K, XA, XB / V, [&](int s, int a, int j) {
      const int gi = i0 - E + a, tj = j0 + j * V;
      const bool in = gi >= 0 && gi < g.nr && tj < TR;
      const T* src = s < S_INVD ? P.M + kTableSource[s] * MS
                                : P.invD + (s - S_INVD) * MS;
      shell::stage16(stab + s * nTab + a * XB + j * V,
                     src + (in ? (int64_t)gi * TR + tj : 0), in);
    });
  } else {
    for (int e = threadIdx.x; e < nTab; e += blockDim.x) {
      const int gi = i0 - E + e / XB, tj = j0 - E + e % XB + P.GH;
      const bool in = gi >= 0 && gi < g.nr && tj >= 0 && tj < TR;
      const int64_t mi = in ? (int64_t)gi * TR + tj : 0;
#pragma unroll
      for (int s = 0; s < 13; ++s)
        stage(stab + s * nTab + e, P.M + kTableSource[s] * MS + mi, in);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        stage(stab + (S_INVD + q) * nTab + e, P.invD + q * MS + mi, in);
    }
  }

  // x of channel q on the level-0 box, into buffer q % 2: x0 (storage
  // type) on the first pass, else the previous pass's iterate
  const bool first = P.xu0 != nullptr;
  auto stage_x = [&](int q) {
    T* dst = sxb + (q & 1) * nX;
    if (first)
      stage_box(dst, q < 3 ? P.xu0 + q * NI : P.xT0, XA, XB, XC, XP, 0, E);
    else
      stage_box(dst, q < 3 ? P.xu_in + q * NI : P.xT_in, XA, XB, XC, XP, 0,
                E);
    stage_commit();
  };
  stage_x(0);

  T s_ru = T(0), s_bu = T(0), s_rT = T(0), s_bT = T(0), s_rhs = T(0);
  const int sAx = XB * XP, sAr = RBx * RP;

  for (int q = 0; q < 4; ++q) {
    const bool mom = q < 3;
    const int n = mom ? P.n_u : P.n_T;
    const T coef = mom ? P.coef_u : P.coef_T;
    const S* bsrc = mom ? P.rhs_u + q * NI : P.rhs_T;
    const T* rin = mom ? (P.ru_in ? P.ru_in + q * N : nullptr) : P.rT_in;
    // x0 is b's source (first momentum pass; a caller's T0 = rhs_T)
    const bool b_is_x = first && (mom ? P.xu0 + q * NI : P.xT0) == bsrc;
    const int dl = q == 0 ? S_DL_UR : S_DL_OTH;
    const T* tinv = stab + (S_INVD + q) * nTab;

    T* sx = sxb + (q & 1) * nX;
    // stage on level 1 the previous pass's r (into sr) or b unless it is
    // x0 (into sdx), and the next channel's x; the previous channel's
    // readers are done: the loop ends in a barrier
    if (rin != nullptr)
      stage_box(sr_raw, rin, RA, RBx, RC, RP, L1, E - 1);
    else if (!b_is_x)
      stage_box(sdx_raw, bsrc, RA, RBx, RC, RP, L1, E - 1);
    stage_commit();
    if (q < 3) {
      stage_x(q + 1);
      stage_wait<1>();
    } else {
      stage_wait<0>();
    }
    __syncthreads();
    PROBE(0);

    // L v along a row segment in conductance form: v at ix (strides sA
    // radial, sB lat, 1 lon), the row's tables in registers, the lon
    // neighbours carried; emit(j, v, Lv) for each cell
    auto lap_row = [&](const T* v, int ix, int len, int sA, int sB, int t,
                       auto&& emit) {
      const T crl = stab[S_CR_LO * nTab + t], crh = stab[S_CR_HI * nTab + t];
      const T cll = stab[S_CL_LO * nTab + t], clh = stab[S_CL_HI * nTab + t];
      const T co = stab[S_CO * nTab + t], dlv = stab[dl * nTab + t];
      T vm = v[ix - 1], f = v[ix];
      for (int j = 0; j < len; ++j, ++ix) {
        const T vp = v[ix + 1];
        T acc = crl * (v[ix - sA] - f);
        acc = acc + crh * (v[ix + sA] - f);
        acc = acc + cll * (v[ix - sB] - f);
        acc = acc + clh * (v[ix + sB] - f);
        acc = acc + co * ((vm - f) + (vp - f));
        emit(j, f, acc + dlv * f);
        vm = f;
        f = vp;
      }
    };

    // first pass: r = b - A x on level 1, and |b|^2 over the tile
    if (rin == nullptr) {
      for_rows<THREADS>(RA, RBx, RC, [&](int a, int b, int c0, int len) {
        const int t = (a + 1) * XB + b + 1;
        const T vol = stab[S_VOL * nTab + t];
        const int ir0 = (a * RBx + b) * RP + c0;
        const bool sum_b = P.last && own_row(a + 1 - E, b + 1 - E);
        lap_row(sx, t * XP + c0 + 1, len, sAx, XP, t, [&](int j, T x, T Lx) {
          T bv = b_is_x ? x : sdx[ir0 + j];
          if (mom) bv = vol * bv;
          sr[ir0 + j] = bv - (vol * x - coef * Lx);
          if (sum_b && own_col(c0 + j + 1 - E)) {
            if (mom)
              s_bu += bv * bv;
            else
              s_bT += bv * bv;
          }
        });
      });
      __syncthreads();
    }
    PROBE(1);

    // sweeps: dx on level s, r on level s + 1
    for (int s = 1; s <= n; ++s) {
      const int o = s - 1;
      for_rows<THREADS>(RA - 2 * o, RBx - 2 * o, RC - 2 * o,
               [&](int a, int b, int c0, int len) {
                 const int t = (a + s) * XB + b + s;
                 const T iD = tinv[t];
                 const int ir = ((a + o) * RBx + b + o) * RP + c0 + o;
                 const int ix = t * XP + c0 + s;
                 for (int j = 0; j < len; ++j) {
                   const T d = sr[ir + j] * iD;
                   sdx[ir + j] = d;
                   sx[ix + j] += d;
                 }
               });
      __syncthreads();
      // residual-free: the last sweep of the last pass leaves r as it is
      if (!TRACK && P.last && s == n) break;
      for_rows<THREADS>(RA - 2 * s, RBx - 2 * s, RC - 2 * s,
               [&](int a, int b, int c0, int len) {
                 const int t = (a + s + 1) * XB + b + s + 1;
                 const T vol = stab[S_VOL * nTab + t];
                 const int ir0 = ((a + s) * RBx + b + s) * RP + c0 + s;
                 lap_row(sdx, ir0, len, sAr, RP, t, [&](int j, T d, T Ld) {
                   sr[ir0 + j] = sr[ir0 + j] - (vol * d - coef * Ld);
                 });
               });
      __syncthreads();
    }
    PROBE(2);

    // the tile: iterate out (and the residual, before a later pass); on
    // the last pass |r|^2 and this component's faces and divergence term
    // (shell::faces_div_cell's arithmetic, in its order)
    S* xout = mom ? P.xu_out + q * N : P.xT_out;
    T* xscr = mom ? P.xu_scr + q * N : P.xT_scr;
    T* rout = mom ? P.ru_out + q * N : P.rT_out;
    for_box<THREADS>(RB, TL, TO, [&](int a, int b, int c) {
      if (!own_row(a, b) || !own_col(c)) return;
      const int gi = i0 + a, gj = j0 + b;
      const int64_t cg = g.cell(gi, gj, k0 + c);
      const int t = (a + E) * XB + b + E;
      const int ix = t * XP + c + E;
      const T x = sx[ix];
      const T r = sr[((a + E - 1) * RBx + b + E - 1) * RP + c + E - 1];
      if (!P.last) {
        xscr[cg] = x;
        rout[cg] = r;
        return;
      }
      xout[cg] = narrow<S>(x);
      const T vol = stab[S_VOL * nTab + t];
      if (rin != nullptr) {  // a later pass: |b|^2 from device memory
        const T bv = mom ? vol * widen(bsrc[cg]) : widen(bsrc[cg]);
        if (mom)
          s_bu += bv * bv;
        else
          s_bT += bv * bv;
      }
      if (!mom) {
        if (TRACK) s_rT += r * r;
        return;
      }
      if (TRACK) s_ru += r * r;
      T f, aq_up, a_lo;
      S* fout;
      if (q == 0) {
        f = gi == 0 ? T(0) : T(0.5) * (sx[ix - sAx] + x);
        aq_up = gi + 1 < g.nr
                    ? stab[S_AR_HI * nTab + t] * (T(0.5) * (x + sx[ix + sAx]))
                    : T(0);
        a_lo = stab[S_AR_LO * nTab + t];
        fout = P.f0;
      } else if (q == 1) {
        // the pole faces by the global row
        f = P.j_off + gj == 0 ? T(0) : T(0.5) * (sx[ix - XP] + x);
        aq_up = P.j_off + gj + 1 < P.nlat_glob
                    ? stab[S_ALAT_HI * nTab + t] * (T(0.5) * (x + sx[ix + XP]))
                    : T(0);
        a_lo = stab[S_ALAT_LO * nTab + t];
        fout = P.f1;
      } else {
        f = T(0.5) * (sx[ix - 1] + x);
        aq_up = stab[S_ALON * nTab + t] * (T(0.5) * (x + sx[ix + 1]));
        a_lo = stab[S_ALON * nTab + t];
        fout = P.f2;
      }
      fout[cg] = narrow<S>(f);
      const T d = aq_up - a_lo * f;
      const int id = (a * TL + b) * TO + c;
      sdiv[id] = q == 0 ? d : sdiv[id] + d;
    });
    __syncthreads();
    PROBE(3);
  }
  if (!P.last) return;

  // Poisson right-hand side of the tile
  for_box<THREADS>(RB, TL, TO, [&](int a, int b, int c) {
    if (!own_row(a, b) || !own_col(c)) return;
    const T vol = stab[S_VOL * nTab + (a + E) * XB + b + E];
    const T div = sdiv[(a * TL + b) * TO + c] / vol;
    const T rhs = (-vol) * div / P.dt;
    P.rhs_raw[g.cell(i0 + a, j0 + b, k0 + c)] = narrow<S>(rhs);
    s_rhs += rhs;
  });

  PROBE(4);
  // per-block partials, then the last block to finish sums them
  block_sum5(s_ru, s_bu, s_rT, s_bT, s_rhs, sred);
  if (threadIdx.x == 0) {
    T* out = P.parts + (int64_t)blockIdx.x * 5;
    out[0] = s_ru;
    out[1] = s_bu;
    out[2] = s_rT;
    out[3] = s_bT;
    out[4] = s_rhs;
    __threadfence();
    is_last = atomicAdd(P.counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  PROBE(5);
  if (!is_last) return;
  __threadfence();
  T t0 = T(0), t1 = T(0), t2 = T(0), t3 = T(0), t4 = T(0);
  for (int p = threadIdx.x; p < (int)gridDim.x; p += blockDim.x) {
    const T* in = P.parts + (int64_t)p * 5;
    t0 += __ldcg(in);
    t1 += __ldcg(in + 1);
    t2 += __ldcg(in + 2);
    t3 += __ldcg(in + 3);
    t4 += __ldcg(in + 4);
  }
  block_sum5(t0, t1, t2, t3, t4, sred);
  if (threadIdx.x == 0) {
    P.sums[0] = t0;
    P.sums[1] = t1;
    P.sums[2] = t2;
    P.sums[3] = t3;
    P.sums[4] = t4;
    *P.counter = 0u;
  }
}

// raise an instance's dynamic shared memory limit to `bytes` where a
// launch (or an occupancy query) needs more than it has (per dtype; slot:
// K1 / K1u 0-3, K1o 4)
template <typename S>
int allow_smem(void (*kernel)(const Pass<S>), int slot, int bytes) {
  static int set[5] = {48 * 1024, 48 * 1024, 48 * 1024, 48 * 1024,
                       48 * 1024};
  if (bytes <= set[slot]) return 0;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err) return err;
  set[slot] = bytes;
  return 0;
}

// xu_in / xT_in: x0 in the storage type on the first pass (ru_in null),
// else the previous pass's iterates in the compute type; xu_out /
// xT_out: the storage type on the last pass, else the compute type
template <typename S, typename T = compute_t<S>>
int launch(int nr, int nlat, int nlon, int RB, int TL, int TO, int E,
           int smem_bytes, const T* M, const T* invD, const void* xu_in,
           const void* xT_in, const S* rhs_u, const S* rhs_T, const T* ru_in,
           const T* rT_in, double dt,
           double iRe, double iPe, double dt_T_factor, int n_u, int n_T,
           int last, void* xu_out, void* xT_out, T* ru_out, T* rT_out, S* f0,
           S* f1, S* f2, S* rhs_raw, T* parts, unsigned* counter, T* sums,
           int track, int eL, int eO, int GH, int j_off, int nlat_glob,
           void* stream) {
  // the bench's plan runs a compile-time instance, which takes about 12%
  // less time on an H100 than the run-time-tiled one on the same plan
  // (PERF.md, Findings); -DK1_RUNTIME_TILE (scripts/probe_k1_k2.py) runs
  // every plan on the latter. K1o (GH > 0) runs the run-time-tiled one:
  // compile-time instances of its plans at the bench's shards spill
  // (PERF.md §6).
  const bool ops = GH > 0;
#ifdef K1_RUNTIME_TILE
  const bool bench = false;
#else
  const bool bench = !ops && RB == 8 && TL == 8 && TO == 32 && E == 2;
#endif
  void (*kernel)(const Pass<S>) =
      ops ? rich_fused<S, 0, 0, 0, 0, true, true>
      : track ? (bench ? rich_fused<S, 8, 8, 32, 2, true, false>
                       : rich_fused<S, 0, 0, 0, 0, true, false>)
              : (bench ? rich_fused<S, 8, 8, 32, 2, false, false>
                       : rich_fused<S, 0, 0, 0, 0, false, false>);
  const int v = ops ? 4 : 2 * (track != 0) + bench;
  const int err = allow_smem<S>(kernel, v, smem_bytes);
  if (err) return err;
  Pass<S> P;
  P.g = Dims{nr, nlat, nlon};
  P.RB = RB;
  P.TL = TL;
  P.TO = TO;
  P.E = E;
  P.nbo = (nlon + TO - 1) / TO;
  P.nbl = (nlat + TL - 1) / TL;
  const int nbr = (nr + RB - 1) / RB;
  P.M = M;
  P.invD = invD;
  const bool first = ru_in == nullptr;
  P.xu0 = first ? static_cast<const S*>(xu_in) : nullptr;
  P.xT0 = first ? static_cast<const S*>(xT_in) : nullptr;
  P.xu_in = first ? nullptr : static_cast<const T*>(xu_in);
  P.xT_in = first ? nullptr : static_cast<const T*>(xT_in);
  P.rhs_u = rhs_u;
  P.rhs_T = rhs_T;
  P.ru_in = ru_in;
  P.rT_in = rT_in;
  P.ru_out = ru_out;
  P.rT_out = rT_out;
  P.n_u = n_u;
  P.n_T = n_T;
  P.last = last;
  const T dt_t = T(dt);
  P.coef_u = dt_t * T(iRe);
  P.coef_T = (dt_t * T(dt_T_factor)) * T(iPe);
  P.dt = dt_t;
  P.xu_out = last ? static_cast<S*>(xu_out) : nullptr;
  P.xT_out = last ? static_cast<S*>(xT_out) : nullptr;
  P.xu_scr = last ? nullptr : static_cast<T*>(xu_out);
  P.xT_scr = last ? nullptr : static_cast<T*>(xT_out);
  P.f0 = f0;
  P.f1 = f1;
  P.f2 = f2;
  P.rhs_raw = rhs_raw;
  P.parts = parts;
  P.counter = counter;
  P.sums = sums;
  P.eL = eL;
  P.eO = eO;
  P.GH = GH;
  P.j_off = j_off;
  P.nlat_glob = nlat_glob;
  // K1o's 16-byte rows (one pass of halo GH): the extended rows a
  // multiple of 16 bytes, every tile's first column / row on a 16-byte
  // boundary, the operands 16-byte aligned; the tables' rows also XB = TL
  // + 2E values a multiple of 16 bytes. The rows of bfloat16 operands go
  // value by value (widened as they are staged)
  constexpr int V = 16 / (int)sizeof(T);
  auto a16 = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  P.vrow = std::is_same_v<S, T> && ops && E == GH && eO % V == 0 &&
           (TO % V == 0 || P.nbo == 1) && a16(xu_in) && a16(xT_in) &&
           a16(rhs_u) && a16(rhs_T);
  P.vtab = ops && E == GH && eL % V == 0 && (TL + 2 * E) % V == 0 &&
           (TL % V == 0 || P.nbl == 1) && a16(M) && a16(invD);
  const unsigned grid = (unsigned)(nbr * P.nbl * P.nbo);
  kernel<<<grid, THREADS, smem_bytes, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

// resident blocks an SM of K1o's instance with smem_bytes of dynamic
// shared memory, into *blocks
template <typename S>
int occupancy(int smem_bytes, int* blocks) {
  void (*kernel)(const Pass<S>) = rich_fused<S, 0, 0, 0, 0, true, true>;
  const int err = allow_smem<S>(kernel, 4, smem_bytes);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, THREADS, smem_bytes);
}

}  // namespace

// NAME: one pass of K1 / K1u on the whole grid. NAME_operands: K1o, one
// tracked pass on a shard of nr x nlat x nlon owned cells whose inputs
// (and tables) are extended by GH cells in lat and lon (extents eL, eO),
// the shard's first row being global row j_off of nlat_glob.
// NAME_occupancy: resident blocks an SM of K1o's instance with
// smem_bytes of dynamic shared memory.
// S: the fields' storage type, T: the compute type (tables, scratch, sums)
#define RICHARDSON_ARGS(S, T)                                                \
  int nr, int nlat, int nlon, int RB, int TL, int TO, int E, int smem_bytes, \
      const T *M, const T *invD, const void *xu_in, const void *xT_in,       \
      const S *rhs_u, const S *rhs_T, const T *ru_in, const T *rT_in,        \
      double dt, double iRe, double iPe, double dt_T_factor, int n_u,        \
      int n_T, int last, void *xu_out, void *xT_out, T *ru_out, T *rT_out,   \
      S *f0, S *f1, S *f2, S *rhs_raw, T *parts, unsigned *counter, T *sums
#define RICHARDSON_CALL(S, track, eL, eO, GH, j_off, nlat_glob)               \
  launch<S>(nr, nlat, nlon, RB, TL, TO, E, smem_bytes, M, invD, xu_in, xT_in,   \
         rhs_u, rhs_T, ru_in, rT_in, dt, iRe, iPe, dt_T_factor, n_u, n_T,    \
         last, xu_out, xT_out, ru_out, rT_out, f0, f1, f2, rhs_raw, parts,   \
         counter, sums, track, eL, eO, GH, j_off, nlat_glob, stream)
#define RICHARDSON_ENTRY(NAME, S, T)                                         \
  extern "C" int NAME(RICHARDSON_ARGS(S, T), int track, void* stream) {      \
    return RICHARDSON_CALL(S, track, nlat, nlon, 0, 0, nlat);                \
  }                                                                          \
  extern "C" int NAME##_operands(RICHARDSON_ARGS(S, T), int GH, int j_off,   \
                                 int nlat_glob, void* stream) {              \
    return RICHARDSON_CALL(S, 1, nlat + 2 * GH, nlon + 2 * GH, GH, j_off,    \
                           nlat_glob);                                       \
  }                                                                          \
  extern "C" int NAME##_occupancy(int smem_bytes, int* blocks) {             \
    return occupancy<S>(smem_bytes, blocks);                                 \
  }

RICHARDSON_ENTRY(dp_richardson_f32, float, float)
RICHARDSON_ENTRY(dp_richardson_f64, double, double)
RICHARDSON_ENTRY(dp_richardson_bf16, __nv_bfloat16, float)
