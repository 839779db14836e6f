// K2: explicit forcing of the shell standard (advective) personality,
// with the temperature transport fused in the same pass; K2m, the same
// forcing without the transport (forcing_kernel<T, false, false>); and
// K2o and K2mo, K2 and K2m on one shard of a mesh (forcing_kernel<T,
// true, true> and <T, false, true>, below).
//
// Replaces the Pallas kernel ShellForcingPallas._build_call
// (dycoreplanet_tpu/ops/pallas_stencil.py:373), with advect_T = true
// (K2) and false (K2m, the semi-Lagrangian temperature path). Computes,
// per cell,
//
//   rhs_u = u + dt * ( -(adv(u) + curv(u)) + cor(u) + buoy(T)
//                      + visc_curv(u) / Re - grad p )
//   T_adv = T - dt_T * (div(u_f T) - T div(u_f))          (K2 only)
//
// with MUSCL (van Leer) / upwind / centred face reconstruction, the
// ghost rules of ops/bc.py and a Dirichlet inner wall for T.
//
// Bound: device-memory traffic. K2 reads u (3 fields), the three face
// velocities, T and p, and writes rhs_u (3) and T_adv: 12 fields of
// nr*nlat*nlon values (~50 MB at 32x128x256 f32), against roughly
// 480 floating-point operations per cell. K2m reads the same 8 and
// writes rhs_u: 11 fields (~46 MB), ~390 operations per cell.
//
// Design (2.5-D): a block of 8 x 32 threads owns a TL x TO = 8 x 32
// lat-lon tile and marches along the radius over a chunk of planes
// (ops/forcing.py `plan`), one cell per thread and plane:
//   * each plane of u0, u1, u2, T (halo 2, for MUSCL), p (halo 1), the
//     face velocities and the plane's metric rows is staged in shared
//     memory with cp.async, double-buffered: plane i+1 is in flight
//     while plane i is computed. The lateral ghost rules are applied as
//     it is staged (periodic lon, the pole ring at lon + pi; the pole
//     ring's sign after arrival), so the compute reads no ghost index;
//   * the radial neighbours i-1..i+2 are a register window per thread,
//     filled with the radial ghost rules (ANTISYM / NEUMANN, T's
//     DIRICHLET inner wall) as they are loaded;
//   * every face flux is computed once: the lat and lon fluxes of the
//     plane go to shared memory for the two cells beside each face, the
//     radial flux of the face above is carried to the next plane;
//   * the metric comes as lon-invariant (K, nr, nlat) tables with the
//     reciprocals of the volume, the radius and the face distances
//     (ops/forcing.py), so the only divides left are the van Leer
//     limiter's;
//   * one limiter per face, formed without divergence, and the faces
//     dealt evenly to the threads;
//   * no local arrays, so that ptxas keeps everything in registers, and
//     __launch_bounds__ for two blocks an SM in f32 (one in f64, whose
//     registers are twice as wide);
//   * K2m (ADVECT_T = false) stages u0, u1, u2 only, forms no T flux and
//     reads T at the cell alone (buoyancy), one coalesced load a plane:
//     its planes and flux arrays in shared memory hold 3 fields, not 4
//     (Lay<false>), and it reads no T_wall and writes no T_adv;
//   * K2o / K2mo (OPS = true) stage a tile's halo from the shard where it
//     lies in the shard and from the ghost operands where it leaves it
//     (the exchange applied the pole roll and sign); K2mo stages no T
//     ghost, reading T at the cell as K2m does, and takes no HLT / HOT.
//
// K2o / K2mo on a shard (a quarter or an eighth of the grid) are bound by
// the card's fill, not by its bytes: at K2's 16 planes a block, a shard
// gives 32-64 blocks for 264 resident slots (132 SMs x 2), and the time
// is one block's march, whatever the shard's size. So:
//   * the radial chunk comes from the shard and the card (ops/forcing.py
//     `plan_operands`: the fewest planes a resident slot marches, then
//     the longest chunk, since each block repeats the prologue), down to
//     one plane a block;
//   * staging goes by rows, not by elements: each staged row of each
//     field picks its source once (the shard's row, a lat ghost row of
//     HL*, or zero past the ghosts) and goes as 16-byte cp.async chunks
//     into rows that start on a 16-byte boundary at lon k0 - 4
//     (Lay<…, true>: pitch TO + 8, k0 at column 4), the lon halo with
//     the interior where it lies in the shard; at the shard's lon edge a
//     field's two ghosts on that side are one pair in HO*, one copy
//     (p's and the lon faces' one ghost a side go value by value). Where
//     16-byte copies cannot be aligned (nlon not a multiple of 16 bytes'
//     values, or a row operand's base pointer off a 16-byte boundary:
//     Args::vec false) every value goes on its own. TMA boxes are not
//     used: a tile's rows come from up to three arrays (the shard, HL*,
//     HO*) with per-row sources, which one box cannot describe, and the
//     copies stay in the threads' commit groups that the double buffer
//     waits on.
// What bounds them now is the staging's per-copy instructions (choosing
// each chunk's source, once a plane) and the radial window's loads, both
// repeated by every block (PERF.md §6-7, PR 10).
//
// Every form comes in float, double and bfloat16 storage (ST below;
// shell_common.cuh): the bfloat16 forms widen each value as they stage
// or load it, hold the planes, fluxes and tables in float, compute in
// float and round rhs_u and T_adv once. Their staging goes value by
// value (cp.async cannot widen), so the operands mode's 16-byte rows are
// off for them (Args::vec 0).
#include "shell_common.cuh"

namespace {

using shell::compute_t;
using shell::Dims;
using shell::narrow;
using shell::stage;
using shell::widen;
using shell::stage_commit;
using shell::stage_wait;
using shell::wrap_any;

constexpr int TL = 8, TO = 32, THREADS = TL * TO;
constexpr int PW = TO + 4, PH = TL + 4;      // plane with halo 2
constexpr int QW = TO + 2;                   // p plane with halo 1
constexpr int NXL = (TL + 1) * TO;           // lat faces j0..j0+TL
constexpr int NXO = TL * (TO + 1);           // lon faces k0..k0+TO
constexpr int MR = TL + 1;                   // metric rows j0..j0+TL

// metric channels at (i, j) (ops/forcing.py `_M64`)
enum {
  M_IVOL = 0, M_AR_LO, M_AR_HI, M_ALAT_LO, M_ALAT_HI, M_ALON,
  M_IDR_LO, M_IDR_HI, M_IDLAT_LO, M_IDLAT_HI, M_IDLON, M_IR, M_GR, M_K
};
// lat rows: cos, tan, sin, 1 / cos
enum { L_COS = 0, L_TAN, L_SIN, L_ICOS, L_K };

// a region's size in values, rounded up to 16 bytes in the operands mode
template <bool OPS>
constexpr int al(int n) {
  return OPS ? (n + 3) / 4 * 4 : n;
}

// the shared-memory layout (in values) of a block; NF fields staged with
// halo 2: u0, u1, u2 and, with the transport, T. The operands mode (OPS)
// starts every staged row (a field's and p's at lon k0 - 4) and every
// region on a 16-byte boundary, for its 16-byte copies.
template <bool ADVECT_T, bool OPS = false>
struct Lay {
  static constexpr int NF = ADVECT_T ? 4 : 3;
  // row pitches, and the column of lon k0 in a row: the fields (halo 2),
  // p (halo 1), the lon faces (k0..k0+TO)
  static constexpr int FP = OPS ? TO + 8 : PW, FK = OPS ? 4 : 2;
  static constexpr int PP = OPS ? TO + 8 : QW, PK = OPS ? 4 : 1;
  static constexpr int XW = OPS ? TO + 4 : TO + 1;
  // one staged plane: offsets into its buffer
  static constexpr int O_F = 0;                             // u0, u1, u2(, T)
  static constexpr int O_P = O_F + NF * PH * FP;            // p
  static constexpr int O_F1 = O_P + al<OPS>((TL + 2) * PP); // lat faces
  static constexpr int O_F2 = O_F1 + al<OPS>(NXL);          // lon faces
  static constexpr int O_M = O_F2 + al<OPS>(TL * XW);       // metric rows
  static constexpr int PLANE = O_M + al<OPS>(M_K * MR);
  // the block's shared memory: two planes, the face fluxes, the lat rows
  static constexpr int O_XL = 2 * PLANE;             // NF fields' lat fluxes
  static constexpr int O_XO = O_XL + NF * NXL;       // NF fields' lon fluxes
  static constexpr int O_LAT = O_XO + NF * NXO;
  static constexpr int SMEM_VALUES = O_LAT + L_K * TL;
};

// ST: the fields' storage type; the tables and scalars are its compute
// type T
template <typename ST, typename T = compute_t<ST>>
struct Args {
  Dims g;
  int RS;                  // planes a block marches over
  int nbo, nbl;            // tiles along lon and lat
  const ST* u;
  const ST* f0;
  const ST* f1;
  const ST* f2;
  const ST* Tf;
  const ST* p;
  const ST* T_wall;
  const T* M;
  const T* lat;
  T dt, dt_T, beta, T_ref, rho_bg, iRe, omega;
  int scheme, physical_coriolis, perturbation, include_gradp;
  ST* rhs_u;
  ST* T_adv;
  // the metric table's rows (nlat; K2o: the shard's plus one), and the
  // array's first row in the global grid and the global nlat (K2: 0, nlat)
  int mrows, j_off, nlat_glob;
  // K2o's ghost operands (ops/forcing.py halo_shapes); null for K2, and
  // HLT, HOT null for K2mo
  const ST* HLu;
  const ST* HLp;
  const ST* HLf1;
  const ST* HOu;
  const ST* HOp;
  const ST* HOf2;
  const ST* HLT;
  const ST* HOT;
  // K2o: whether every staged row's interior may go as 16-byte copies
  // (nlon a multiple of 16 bytes' values, the row operands 16-byte
  // aligned); 0 for K2
  int vec;
};

// radial window of one advected field along the thread's column
template <typename T>
struct Win {
  T m1, c, p1, p2;         // cells i-1, i, i+1, i+2
  T flo;                   // flux through face i (from the plane below)
};

// centred gradient: mean of the two adjacent face-normal derivatives
template <typename T>
__device__ __forceinline__ T cgrad(T lo, T v, T hi, T idl, T idh) {
  return T(0.5) * ((v - lo) * idl + (hi - v) * idh);
}

// radial cell m of field Q on the column at offset jk of a plane, with
// the ghost rules: u_r ANTISYM / ANTISYM, u_lat, u_lon ANTISYM / NEUMANN,
// T DIRICHLET (2 wall - v) / NEUMANN
template <int Q, typename ST, typename T>
__device__ __forceinline__ T col(const ST* __restrict__ F, const Dims& g,
                                 int64_t plane, int64_t jk, int m, T wall) {
  if (m < 0) {
    const T v = widen(F[jk]);
    return Q == 3 ? T(2) * wall - v : -v;
  }
  if (m >= g.nr) {
    const T v = widen(F[(g.nr - 1) * plane + jk]);
    return Q == 0 ? -v : v;
  }
  return widen(F[m * plane + jk]);
}

// p: NEUMANN at both walls
template <typename ST>
__device__ __forceinline__ compute_t<ST> pcol(const ST* __restrict__ p,
                                              const Dims& g, int64_t plane,
                                              int64_t jk, int m) {
  m = m < 0 ? 0 : (m >= g.nr ? g.nr - 1 : m);
  return widen(p[m * plane + jk]);
}

// the offset in a plane of staged position (r, c) (halo 2) after the
// lateral ghost rules: lon wraps, a row past a pole is the ring at
// lon + pi
__device__ __forceinline__ int64_t plane_src(const Dims& g, int j0, int k0,
                                             int r, int c) {
  const int jj = j0 - 2 + r;
  int kk = wrap_any(k0 - 2 + c, g.nlon);
  const bool pole = jj < 0 || jj >= g.nlat;
  if (pole) kk = wrap_any(kk + g.nlon / 2, g.nlon);
  const int row = jj < 0 ? 0 : (pole ? g.nlat - 1 : jj);
  return (int64_t)row * g.nlon + kk;
}

// K2o: the source rows of a staged row jj (shard coordinates) of a field
// with wl lat ghost rows before the shard and wh after (HL: (nr, wl + wh,
// nlon), rows [g_-wl .. g_-1, g_+1 .. g_+wh]): R, the shard's row or a
// ghost row of HL, and G, the row's lon ghosts in HO ((nr, nlat, gw));
// null where there is none (past the ghosts, and G of a lat ghost row: a
// corner, which no stencil reads)
template <typename T>
__device__ __forceinline__ void row_src(const Dims& g, int i, int jj,
                                        const T* F, const T* HL, int wl,
                                        int wh, const T* HO, int gw,
                                        const T*& R, const T*& G) {
  R = G = nullptr;
  if (jj >= 0 && jj < g.nlat) {
    R = F + ((int64_t)i * g.nlat + jj) * g.nlon;
    if (HO != nullptr) G = HO + ((int64_t)i * g.nlat + jj) * gw;
  } else if (jj < 0 ? jj >= -wl : jj - g.nlat < wh) {
    R = HL + ((int64_t)i * (wl + wh) + (jj < 0 ? jj + wl : wl + jj - g.nlat))
                 * g.nlon;
  }
}

// K2o: stage column kk (shard coordinates) of a row with sources R and G
// (row_src; ow[l|h] lon ghosts before and after the shard) into dst: the
// row inside the shard, G beside it, zero past the ghosts
template <typename T, typename ST>
__device__ __forceinline__ void stage_col(T* dst, const ST* R, const ST* G,
                                          int kk, int nlon, int owl,
                                          int owh, const ST* any) {
  const ST* src = nullptr;
  if (kk >= 0 && kk < nlon) {
    if (R != nullptr) src = R + kk;
  } else if (G != nullptr && (kk < 0 ? kk >= -owl : kk - nlon < owh)) {
    src = G + (kk < 0 ? kk + owl : owl + kk - nlon);
  }
  stage(dst, src != nullptr ? src : any, src != nullptr);
}

// two values from device to shared memory (8 bytes in f32, 16 in f64),
// both addresses aligned to their size; valid = false writes zeros
template <typename T>
__device__ __forceinline__ void stage_pair(T* dst, const T* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(2 * (int)sizeof(T)),
               "r"(valid ? 2 * (int)sizeof(T) : 0)
               : "memory");
}

// K2o: chunk c of a staged row whose column 0 is lon kb, V = 16 bytes'
// values at lon kk = kb + c V, from the row's sources R and G (row_src,
// ow[l|h] lon ghosts before and after the shard). With vec, the chunk is
// one 16-byte copy where it lies in the shard; past the shard's lon edge
// (nlon and kk multiples of V, so a chunk lies wholly in or out) a
// halo-2 field's ghosts [g_-2, g_-1] and [g_+1, g_+2], each a pair in G,
// land on a pair of the chunk, one copy each, and the rest is zero;
// other rows (p, the faces) take their few ghosts value by value. Without
// vec, every value on its own.
template <typename T, typename ST>
__device__ __forceinline__ void stage_chunk(T* drow, const ST* R, const ST* G,
                                            int kb, int c, int nlon, int owl,
                                            int owh, bool vec,
                                            const ST* any) {
  constexpr int V = 16 / (int)sizeof(T);
  const int kk = kb + c * V;
  T* dst = drow + c * V;
  // vec is set only where storage and shared memory share a type
  if constexpr (std::is_same_v<T, ST>) {
    if (vec && (R == nullptr || (kk >= 0 && kk + V <= nlon))) {
      shell::stage16(dst, R != nullptr ? R + kk : any, R != nullptr);
      return;
    }
    if (vec && owl == 2) {
#pragma unroll
      for (int q = 0; q < V; q += 2) {
        const T* src = G == nullptr ? nullptr
                       : kk + q == -2 ? G
                       : kk + q == nlon ? G + 2 : nullptr;
        stage_pair(dst + q, src != nullptr ? src : any, src != nullptr);
      }
      return;
    }
  }
  {
#pragma unroll
    for (int v = 0; v < V; ++v)
      stage_col(dst + v, R, G, kk + v, nlon, owl, owh, any);
  }
}

// stage plane i into buffer D (asynchronous; one commit group)
template <bool ADVECT_T, bool OPS, typename ST, typename T = compute_t<ST>>
__device__ __forceinline__ void stage_plane(const Args<ST>& A, T* D, int i,
                                            int j0, int k0) {
  using Y = Lay<ADVECT_T, OPS>;
  const Dims& g = A.g;
  const int64_t N = g.n_cells();
  const int64_t pi = (int64_t)i * g.nlat * g.nlon;
  if constexpr (OPS) {
    constexpr int V = 16 / (int)sizeof(T);
    constexpr int NC = (TO + 8) / V;      // chunks of a field or p row
    constexpr int N1C = TO / V;           // of a lat face row
    constexpr int N2C = (TO + V) / V;     // of a lon face row (k0..k0+TO)
    const int64_t nHL = (int64_t)g.nr * 4 * g.nlon;  // HLu's component stride
    const int64_t nHO = (int64_t)g.nr * g.nlat * 4;  // HOu's
    const bool vec = A.vec != 0;
    // u0, u1, u2 (and T): PH rows from lon k0 - 4, halo 2
    for (int e = threadIdx.x; e < Y::NF * PH * NC; e += THREADS) {
      const int q = e / (PH * NC), r = e / NC % PH;
      const bool isT = ADVECT_T && q == 3;
      const ST *R, *G;
      row_src(g, i, j0 - 2 + r, isT ? A.Tf : A.u + q * N,
              isT ? A.HLT : A.HLu + q * nHL, 2, 2,
              isT ? A.HOT : A.HOu + q * nHO, 4, R, G);
      stage_chunk(D + Y::O_F + (q * PH + r) * Y::FP, R, G, k0 - 4, e % NC,
                  g.nlon, 2, 2, vec, A.u);
    }
    // p (TL + 2 rows from lon k0 - 4, halo 1); the lat faces j0 .. j0 +
    // TL, whose row nlat is the next shard's first (HLf1); the lon faces
    // k0 .. k0 + TO of TL rows, whose column nlon is the next shard's
    // first (HOf2)
    constexpr int NP = (TL + 2) * NC, N1 = (TL + 1) * N1C, N2 = TL * N2C;
    for (int e = threadIdx.x; e < NP + N1 + N2; e += THREADS) {
      const ST *R, *G;
      if (e < NP) {
        const int r = e / NC;
        row_src(g, i, j0 - 1 + r, A.p, A.HLp, 1, 1, A.HOp, 2, R, G);
        stage_chunk(D + Y::O_P + r * Y::PP, R, G, k0 - 4, e % NC, g.nlon, 1,
                    1, vec, A.u);
      } else if (e < NP + N1) {
        const int r = (e - NP) / N1C;
        row_src(g, i, j0 + r, A.f1, A.HLf1, 0, 1, (const ST*)nullptr, 0, R,
                G);
        stage_chunk(D + Y::O_F1 + r * TO, R, G, k0, (e - NP) % N1C, g.nlon,
                    0, 0, vec, A.u);
      } else {
        const int r = (e - NP - N1) / N2C;
        row_src(g, i, j0 + r, A.f2, (const ST*)nullptr, 0, 0, A.HOf2, 1, R,
                G);
        stage_chunk(D + Y::O_F2 + r * Y::XW, R, G, k0, (e - NP - N1) % N2C,
                    g.nlon, 0, 1, vec, A.u);
      }
    }
  } else {
    for (int e = threadIdx.x; e < PH * PW; e += THREADS) {
      const int r = e / PW, c = e % PW;
      const int64_t idx = pi + plane_src(g, j0, k0, r, c);
      stage(D + Y::O_F + e, A.u + idx, true);
      stage(D + Y::O_F + PH * PW + e, A.u + N + idx, true);
      stage(D + Y::O_F + 2 * PH * PW + e, A.u + 2 * N + idx, true);
      if constexpr (ADVECT_T)
        stage(D + Y::O_F + 3 * PH * PW + e, A.Tf + idx, true);
      if (r >= 1 && r <= TL + 2 && c >= 1 && c <= TO + 2)
        stage(D + Y::O_P + (r - 1) * QW + c - 1, A.p + idx, true);
    }
    for (int e = threadIdx.x; e < NXL; e += THREADS) {
      const int jf = j0 + e / TO;
      const bool in = jf < g.nlat;
      stage(D + Y::O_F1 + e,
            A.f1 + (in ? pi + (int64_t)jf * g.nlon
                             + wrap_any(k0 + e % TO, g.nlon)
                       : 0), in);
    }
    for (int e = threadIdx.x; e < NXO; e += THREADS) {
      const int jj = min(j0 + e / (TO + 1), g.nlat - 1);
      stage(D + Y::O_F2 + e,
            A.f2 + pi + (int64_t)jj * g.nlon
                + wrap_any(k0 + e % (TO + 1), g.nlon),
            true);
    }
  }
  const int64_t MS = (int64_t)g.nr * A.mrows;
  for (int e = threadIdx.x; e < M_K * MR; e += THREADS) {
    const int j = j0 + e % MR;
    const bool in = j < A.mrows;
    stage(D + Y::O_M + e,
          A.M + (in ? (e / MR) * MS + (int64_t)i * A.mrows + j : 0), in);
  }
  stage_commit();
}

// after this thread's copies of a plane arrived: the pole ring's sign
// (POLE_FLIP) on its copies of u_lat and u_lon
template <bool ADVECT_T, typename T>
__device__ __forceinline__ void pole_signs(const Dims& g, T* D, int j0) {
  using Y = Lay<ADVECT_T>;
  for (int e = threadIdx.x; e < PH * PW; e += THREADS) {
    const int jj = j0 - 2 + e / PW;
    if (jj < 0 || jj >= g.nlat) {
      D[Y::O_F + PH * PW + e] = -D[Y::O_F + PH * PW + e];
      D[Y::O_F + 2 * PH * PW + e] = -D[Y::O_F + 2 * PH * PW + e];
    }
  }
}

// the flux of field q through lat face j0 + fr at column k0 + fc of
// the staged plane D (0 through the pole face past the grid)
template <bool ADVECT_T, bool OPS, typename ST, typename T>
__device__ __forceinline__ void lat_flux(const Args<ST>& A, const T* D, T* S,
                                         int q, int fr, int fc, int j0) {
  using Y = Lay<ADVECT_T, OPS>;
  const int jf = j0 + fr, e = fr * TO + fc;
  T flux = T(0);
  if (A.j_off + jf < A.nlat_glob) {
    // cell jf - 2
    const T* v = D + Y::O_F + q * PH * Y::FP + fr * Y::FP + fc + Y::FK;
    const T uf = D[Y::O_F1 + e];
    flux = D[Y::O_M + M_ALAT_LO * MR + fr]
           * (uf * shell::face_value<T>(v[0], v[Y::FP], v[2 * Y::FP],
                                        v[3 * Y::FP], A.j_off + jf == 0,
                                        false, uf, A.scheme));
  }
  S[Y::O_XL + q * NXL + e] = flux;
}

// the flux of field q through lon face k0 + fc of tile row fr
template <bool ADVECT_T, bool OPS, typename ST, typename T>
__device__ __forceinline__ void lon_flux(const Args<ST>& A, const T* D, T* S,
                                         int q, int fr, int fc) {
  using Y = Lay<ADVECT_T, OPS>;
  const int e = fr * (TO + 1) + fc;
  // cell kf - 2
  const T* v = D + Y::O_F + q * PH * Y::FP + (fr + 2) * Y::FP + fc
               + (Y::FK - 2);
  const T uf = D[Y::O_F2 + (OPS ? fr * Y::XW + fc : e)];
  S[Y::O_XO + q * NXO + e] =
      D[Y::O_M + M_ALON * MR + fr]
      * (uf * shell::face_value<T>(v[0], v[1], v[2], v[3], false, false, uf,
                                   A.scheme));
}

// the lat and lon face fluxes of the NF fields on plane D: each thread
// the lower lat and lon faces of its cell, and threads 0..NF*(TO+TL)-1
// one of the faces past the tile (lat row TL, lon column TO)
template <bool ADVECT_T, bool OPS, typename ST, typename T>
__device__ __forceinline__ void plane_fluxes(const Args<ST>& A, const T* D,
                                             T* S, int j0) {
  constexpr int NF = Lay<ADVECT_T>::NF;
  const int tx = threadIdx.x % TO, ty = threadIdx.x / TO;
  for (int q = 0; q < NF; ++q) {
    lat_flux<ADVECT_T, OPS>(A, D, S, q, ty, tx, j0);
    lon_flux<ADVECT_T, OPS>(A, D, S, q, ty, tx);
  }
  const int t = threadIdx.x;
  if (t < NF * TO)
    lat_flux<ADVECT_T, OPS>(A, D, S, t / TO, TL, t % TO, j0);
  else if (t < NF * TO + NF * TL)
    lon_flux<ADVECT_T, OPS>(A, D, S, (t - NF * TO) / TL, (t - NF * TO) % TL,
                            TO);
}

// the advective flux sum of field Q at the thread's cell (not yet / vol),
// in the order of the axes; carries the radial flux of face i+1
template <int Q, bool ADVECT_T, bool OPS, typename ST, typename T>
__device__ __forceinline__ T flux_sum(const Args<ST>& A, const T* S,
                                      Win<T>& w, int i, T ar_hi, T uf_up) {
  using Y = Lay<ADVECT_T, OPS>;
  T fup = T(0);
  if (i + 1 < A.g.nr)
    fup = ar_hi * (uf_up * shell::face_value<T>(w.m1, w.c, w.p1, w.p2, false, false,
                                       uf_up, A.scheme));
  const int tx = threadIdx.x % TO, ty = threadIdx.x / TO;
  const T* XL = S + Y::O_XL + Q * NXL;
  const T* XO = S + Y::O_XO + Q * NXO;
  T acc = fup - w.flo;
  acc = acc + (XL[(ty + 1) * TO + tx] - XL[ty * TO + tx]);
  acc = acc + (XO[ty * (TO + 1) + tx + 1] - XO[ty * (TO + 1) + tx]);
  w.flo = fup;
  return acc;
}

template <int Q, typename ST, typename T>
__device__ __forceinline__ void win_start(const Args<ST>& A, const ST* F,
                                          Win<T>& w, int64_t plane,
                                          int64_t jk, int i, T wall, T uf,
                                          T ar_lo) {
  const Dims& g = A.g;
  const T m2 = col<Q>(F, g, plane, jk, i - 2, wall);
  w.m1 = col<Q>(F, g, plane, jk, i - 1, wall);
  w.c = col<Q>(F, g, plane, jk, i, wall);
  w.p1 = col<Q>(F, g, plane, jk, i + 1, wall);
  w.flo = ar_lo * (uf * shell::face_value<T>(m2, w.m1, w.c, w.p1, i == 0, false, uf,
                                    A.scheme));
}

template <typename T>
__device__ __forceinline__ void win_shift(Win<T>& w) {
  w.m1 = w.c;
  w.c = w.p1;
  w.p1 = w.p2;
}

template <typename ST, bool ADVECT_T, bool OPS>
__global__ void __launch_bounds__(THREADS, sizeof(compute_t<ST>) == 4 ? 2 : 1)
    forcing_kernel(const Args<ST> A) {
  using T = compute_t<ST>;
  using Y = Lay<ADVECT_T, OPS>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);
  PROBE_START;
  const Dims& g = A.g;
  const int64_t N = g.n_cells();
  const int64_t plane = (int64_t)g.nlat * g.nlon;
  const int64_t MS = (int64_t)g.nr * A.mrows;
  int blk = blockIdx.x;
  const int bo = blk % A.nbo;
  blk /= A.nbo;
  const int bl = blk % A.nbl, bc = blk / A.nbl;
  const int j0 = bl * TL, k0 = bo * TO;
  const int ib = bc * A.RS, ie = min(g.nr, ib + A.RS);
  const int tx = threadIdx.x % TO, ty = threadIdx.x / TO;
  const int j = j0 + ty, k = k0 + tx;
  const bool own = j < g.nlat && k < g.nlon;
  const int jc = min(j, g.nlat - 1);
  const int64_t jk = (int64_t)jc * g.nlon + wrap_any(k, g.nlon);
  const ST* u0 = A.u;
  const ST* u1 = A.u + N;
  const ST* u2 = A.u + 2 * N;
  // T's inner-wall value: only the transport reads it
  const T wall = ADVECT_T ? widen(A.T_wall[jk]) : T(0);

  // the lat rows of the tile, and the first plane
  for (int e = threadIdx.x; e < L_K * TL; e += THREADS)
    stage(S + Y::O_LAT + e,
          A.lat + (e / TL) * g.nlat + min(j0 + e % TL, g.nlat - 1), true);
  stage_plane<ADVECT_T, OPS>(A, S, ib, j0, k0);
  PROBE(14);

  // the windows at the first plane, and the flux through its lower face
  Win<T> w0, w1, w2, wT;
  {
    const T uf = widen(A.f0[ib * plane + jk]);
    const T ar_lo = A.M[M_AR_LO * MS + (int64_t)ib * A.mrows + jc];
    win_start<0>(A, u0, w0, plane, jk, ib, wall, uf, ar_lo);
    win_start<1>(A, u1, w1, plane, jk, ib, wall, uf, ar_lo);
    win_start<2>(A, u2, w2, plane, jk, ib, wall, uf, ar_lo);
    if constexpr (ADVECT_T)
      win_start<3>(A, A.Tf, wT, plane, jk, ib, wall, uf, ar_lo);
  }
  T p_m1 = pcol(A.p, g, plane, jk, ib - 1), p_c = pcol(A.p, g, plane, jk, ib);
  T f0_c = widen(A.f0[ib * plane + jk]);
  PROBE(15);

  for (int i = ib; i < ie; ++i) {
    T* D = S + ((i - ib) & 1) * Y::PLANE;
    __syncthreads();  // the readers of the other buffer (plane i-1) are done
    PROBE(10);
    const bool next = i + 1 < ie;
    if (next)
      stage_plane<ADVECT_T, OPS>(A, S + ((i + 1 - ib) & 1) * Y::PLANE, i + 1,
                                 j0, k0);
    // the column's next radial cells, while the planes are in flight
    w0.p2 = col<0>(u0, g, plane, jk, i + 2, wall);
    w1.p2 = col<1>(u1, g, plane, jk, i + 2, wall);
    w2.p2 = col<2>(u2, g, plane, jk, i + 2, wall);
    T Tcell = T(0);  // K2m: T at the cell, for the buoyancy alone
    if constexpr (ADVECT_T)
      wT.p2 = col<3>(A.Tf, g, plane, jk, i + 2, wall);
    else
      Tcell = widen(A.Tf[i * plane + jk]);
    const T p_p1 = pcol(A.p, g, plane, jk, i + 1);
    const T f0_n =
        i + 1 < g.nr ? widen(A.f0[(int64_t)(i + 1) * plane + jk]) : T(0);
    if (next)
      stage_wait<1>();
    else
      stage_wait<0>();
    if constexpr (!OPS) pole_signs<ADVECT_T>(g, D, j0);
    __syncthreads();
    PROBE(11);
    plane_fluxes<ADVECT_T, OPS>(A, D, S, j0);
    __syncthreads();
    PROBE(12);

    // ---- the cell (i, j, k) -------------------------------------------
    const T* Mt = D + Y::O_M + ty;
    auto m = [&](int ch) { return Mt[ch * MR]; };
    const T ar_hi = m(M_AR_HI);
    const T s0 = flux_sum<0, ADVECT_T, OPS>(A, S, w0, i, ar_hi, f0_n);
    const T s1 = flux_sum<1, ADVECT_T, OPS>(A, S, w1, i, ar_hi, f0_n);
    const T s2 = flux_sum<2, ADVECT_T, OPS>(A, S, w2, i, ar_hi, f0_n);
    T sT = T(0);
    if constexpr (ADVECT_T)
      sT = flux_sum<3, ADVECT_T, OPS>(A, S, wT, i, ar_hi, f0_n);
    // the cell's values; the windows move up a plane now, so that the
    // plane above's cells are not live through the arithmetic below
    const T ur = w0.c, ul = w1.c, up = w2.c;
    const T Tc = ADVECT_T ? wT.c : Tcell;
    win_shift(w0);
    win_shift(w1);
    win_shift(w2);
    if constexpr (ADVECT_T) win_shift(wT);
    if (own) {
      const T* L = S + Y::O_LAT + ty;
      const T cosl = L[L_COS * TL], tanl = L[L_TAN * TL],
              sinl = L[L_SIN * TL], icos = L[L_ICOS * TL];
      const T ivol = m(M_IVOL), ir = m(M_IR);
      // div(u_f), shared by the three momentum components and T
      const T* F1f = D + Y::O_F1;
      const T* F2f = D + Y::O_F2;
      const T dq_r = (i + 1 < g.nr ? ar_hi * f0_n : T(0)) - m(M_AR_LO) * f0_c;
      const T dq_l = (A.j_off + j + 1 < A.nlat_glob
                          ? m(M_ALAT_HI) * F1f[(ty + 1) * TO + tx]
                          : T(0))
                     - m(M_ALAT_LO) * F1f[ty * TO + tx];
      const T alon = m(M_ALON);
      const T dq_o = alon * F2f[ty * Y::XW + tx + 1]
                     - alon * F2f[ty * Y::XW + tx];
      const T div_u = ((dq_r + dq_l) + dq_o) * ivol;

      T adv0 = s0 * ivol - ur * div_u;
      T adv1 = s1 * ivol - ul * div_u;
      T adv2 = s2 * ivol - up * div_u;
      // curvature of (u . grad) u
      adv0 = adv0 + (-(ul * ul + up * up) * ir);
      adv1 = adv1 + (ur * ul * ir + up * up * tanl * ir);
      adv2 = adv2 + (ur * up * ir - ul * up * tanl * ir);

      // Coriolis: none on the shell in the reference mode
      T cor0 = T(0), cor1 = T(0), cor2 = T(0);
      if (A.physical_coriolis) {
        const T om_r = A.omega * sinl, om_l = A.omega * cosl;
        cor0 = T(2) * om_l * up;
        cor1 = T(-2) * om_r * up;
        cor2 = T(2) * (om_r * ul - om_l * ur);
      }

      // buoyancy (radial gravity only)
      const T rho = T(1) - A.beta * (Tc - A.T_ref);
      const T buoy_r = (A.perturbation ? rho - A.rho_bg : rho) * m(M_GR);

      // explicit curvature corrections of the vector Laplacian
      const T idlat_lo = m(M_IDLAT_LO), idlat_hi = m(M_IDLAT_HI),
              idlon = m(M_IDLON);
      const int cc = (ty + 2) * Y::FP + tx + Y::FK;
      const T* F0 = D + Y::O_F;
      const T* F1 = F0 + PH * Y::FP;
      const T* F2 = F1 + PH * Y::FP;
      const T dlat_ur =
          cgrad(F0[cc - Y::FP], ur, F0[cc + Y::FP], idlat_lo, idlat_hi);
      const T dlat_ul =
          cgrad(F1[cc - Y::FP], ul, F1[cc + Y::FP], idlat_lo, idlat_hi);
      const T dlon_ur = cgrad(F0[cc - 1], ur, F0[cc + 1], idlon, idlon);
      const T dlon_ul = cgrad(F1[cc - 1], ul, F1[cc + 1], idlon, idlon);
      const T dlon_up = cgrad(F2[cc - 1], up, F2[cc + 1], idlon, idlon);
      const T irc = ir * icos;
      const T visc0 = T(-2) * ur * (ir * ir)
                      - T(2) * ir * (dlat_ul - ul * tanl * ir + dlon_up);
      const T visc1 = T(2) * ir * dlat_ur - ul * (irc * irc)
                      + T(2) * tanl * ir * dlon_up;
      const T visc2 = T(2) * ir * dlon_ur - T(2) * tanl * ir * dlon_ul
                      - up * (irc * irc);

      T F0v = -adv0 + cor0 + buoy_r + A.iRe * visc0;
      T F1v = -adv1 + cor1 + A.iRe * visc1;
      T F2v = -adv2 + cor2 + A.iRe * visc2;
      if (A.include_gradp) {
        const T* P = D + Y::O_P;
        const int pc = (ty + 1) * Y::PP + tx + Y::PK;
        F0v = F0v - cgrad(p_m1, p_c, p_p1, m(M_IDR_LO), m(M_IDR_HI));
        F1v = F1v - cgrad(P[pc - Y::PP], p_c, P[pc + Y::PP], idlat_lo,
                          idlat_hi);
        F2v = F2v - cgrad(P[pc - 1], p_c, P[pc + 1], idlon, idlon);
      }
      const int64_t cell = (int64_t)i * plane + (int64_t)j * g.nlon + k;
      A.rhs_u[cell] = narrow<ST>(ur + A.dt * F0v);
      A.rhs_u[N + cell] = narrow<ST>(ul + A.dt * F1v);
      A.rhs_u[2 * N + cell] = narrow<ST>(up + A.dt * F2v);
      if constexpr (ADVECT_T) {
        const T adv_T = sT * ivol - Tc * div_u;
        A.T_adv[cell] = narrow<ST>(Tc - A.dt_T * adv_T);
      }
    }
    PROBE(13);
    p_m1 = p_c;
    p_c = p_p1;
    f0_c = f0_n;
  }
}

template <typename ST, bool ADVECT_T, bool OPS>
int launch(const Args<ST>& A, void* stream) {
  const int smem =
      Lay<ADVECT_T, OPS>::SMEM_VALUES * (int)sizeof(compute_t<ST>);
  static bool smem_set = false;
  if (!smem_set && smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        forcing_kernel<ST, ADVECT_T, OPS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
    smem_set = true;
  }
  const unsigned grid =
      (unsigned)(((A.g.nr + A.RS - 1) / A.RS) * A.nbl * A.nbo);
  forcing_kernel<ST, ADVECT_T, OPS>
      <<<grid, THREADS, smem, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}

// resident blocks an SM of one instance (the dynamic shared memory of its
// launch), into *blocks
template <typename ST, bool ADVECT_T, bool OPS>
int occupancy(int* blocks) {
  const int smem =
      Lay<ADVECT_T, OPS>::SMEM_VALUES * (int)sizeof(compute_t<ST>);
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        forcing_kernel<ST, ADVECT_T, OPS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, forcing_kernel<ST, ADVECT_T, OPS>, THREADS, smem);
}

// K2o: whether every staged row may go as 16-byte copies: nlon a multiple
// of 16 bytes' values, the row operands 16-byte aligned, and HOu / HOT
// too, whose ghost pairs go as one copy each (HOp, HOf2: value by value);
// never for bfloat16 storage, whose staging widens value by value
template <typename ST>
int rows_aligned(const Args<ST>& A, bool advect_T) {
  if (!std::is_same_v<ST, compute_t<ST>>) return 0;
  auto a16 = [](const ST* p) { return ((uintptr_t)p & 15) == 0; };
  return A.g.nlon % (16 / (int)sizeof(ST)) == 0 && a16(A.u) && a16(A.p)
         && a16(A.f1) && a16(A.f2) && a16(A.HLu) && a16(A.HLp)
         && a16(A.HLf1) && a16(A.HOu)
         && (!advect_T || (a16(A.Tf) && a16(A.HLT) && a16(A.HOT)));
}

}  // namespace

// NAME: one launch, K2 with advect_T != 0 (T_wall read, T_adv written),
// else K2m (T_wall and T_adv unused, may be null). NAME_occupancy:
// resident blocks an SM of that instance, or with operands != 0 of the
// operands instance (K2o, K2mo). NAME_operands: one launch on a
// shard of nr x nlat x nlon cells whose first row is global row j_off of
// nlat_glob, with its ghost operands and a metric table of nlat + 1
// rows: K2o with advect_T != 0, else K2mo (T_wall, T_adv, HLT and HOT
// unused, may be null).
// S: the fields' storage type, T: the tables' (the compute type)
#define FORCING_ARGS(S, T)                                                \
  int nr, int nlat, int nlon, int RS, const S *u, const S *f0,            \
      const S *f1, const S *f2, const S *Tf, const S *p, const S *T_wall, \
      const T *M, const T *lat, double dt, double dt_T, double beta,      \
      double T_ref, double rho_bg, double iRe, double omega, int scheme,  \
      int physical_coriolis, int perturbation, int include_gradp,         \
      S *rhs_u, S *T_adv
#define FORCING_INIT(S, T, MROWS, JOFF, NLATG)                             \
  Args<S> A{Dims{nr, nlat, nlon}, RS, (nlon + TO - 1) / TO,                \
            (nlat + TL - 1) / TL, u, f0, f1, f2, Tf, p, T_wall, M, lat,    \
            T(dt), T(dt_T), T(beta), T(T_ref), T(rho_bg), T(iRe),          \
            T(omega), scheme, physical_coriolis, perturbation,             \
            include_gradp, rhs_u, T_adv, MROWS, JOFF, NLATG,               \
            nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,          \
            nullptr, nullptr}
#define FORCING_ENTRY(NAME, S, T)                                           \
  extern "C" int NAME(int advect_T, FORCING_ARGS(S, T), void* stream) {     \
    const FORCING_INIT(S, T, nlat, 0, nlat);                                \
    return advect_T ? launch<S, true, false>(A, stream)                     \
                    : launch<S, false, false>(A, stream);                   \
  }                                                                         \
  extern "C" int NAME##_occupancy(int advect_T, int operands,              \
                                  int* blocks) {                            \
    if (operands)                                                           \
      return advect_T ? occupancy<S, true, true>(blocks)                    \
                      : occupancy<S, false, true>(blocks);                  \
    return advect_T ? occupancy<S, true, false>(blocks)                     \
                    : occupancy<S, false, false>(blocks);                   \
  }                                                                         \
  extern "C" int NAME##_operands(int advect_T, FORCING_ARGS(S, T),          \
                                 int j_off, int nlat_glob,                  \
                                 const S* HLu, const S* HLp, const S* HLf1, \
                                 const S* HOu, const S* HOp, const S* HOf2, \
                                 const S* HLT, const S* HOT,                \
                                 void* stream) {                            \
    FORCING_INIT(S, T, nlat + 1, j_off, nlat_glob);                         \
    A.HLu = HLu;                                                            \
    A.HLp = HLp;                                                            \
    A.HLf1 = HLf1;                                                          \
    A.HOu = HOu;                                                            \
    A.HOp = HOp;                                                            \
    A.HOf2 = HOf2;                                                          \
    A.HLT = HLT;                                                            \
    A.HOT = HOT;                                                            \
    A.vec = rows_aligned(A, advect_T != 0);                                 \
    return advect_T ? launch<S, true, true>(A, stream)                      \
                    : launch<S, false, true>(A, stream);                    \
  }

FORCING_ENTRY(dp_forcing_f32, float, float)
FORCING_ENTRY(dp_forcing_f64, double, double)
FORCING_ENTRY(dp_forcing_bf16, __nv_bfloat16, float)
