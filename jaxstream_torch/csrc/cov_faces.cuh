// Device code of the covariant kernels that take all faces of a tile in one
// block: the compact stage (cov_stage.cu), the split del^4 filter
// (cov_nu4_filter.cu), the re-fused stage and the in-stage pair
// (cov_stage_refused_nu4.cu, cov_stage_nu4.cu), the whole-step kernel's
// face phases (cov_step_mega.cu), the right-hand side of ghost-filled
// faces (cov_rhs.cu), the sharded tiers' right-hand sides over a stack of
// ranks (cov_rhs_interior.cu, cov_rhs_local.cu), and the stages over
// whole extended blocks (cov_stage_inkernel.cu, cov_stage_nbr.cu).  On the
// equiangular cube every face has the same metric (it depends on the
// coordinate rows xc, xf alone), and so do the ranks that hold the same
// block position of different faces, so such a block computes the metric
// terms of its tile once, into shared memory, and then runs the
// face-dependent part for each face (or rank) of its group, while the next
// one's window is copied into a second shared buffer asynchronously
// (cp.async).  Every stored value is the float the plain version computes
// with the same operations in the same order (built with -fmad=false), so
// the kernels stay bitwise equal to it.

#pragma once

#include "cov_common.cuh"

namespace cov {

// ---- asynchronous global -> shared copies (cp.async) ----------------------
// The three helpers are all of the kernels' asynchronous staging; the host
// emulation of the kernel sources gives them plain-copy stand-ins.

#ifdef __CUDACC__
// One float, cached in L1 (cp.async.ca).
__device__ __forceinline__ void async_copy4(float* sdst, const float* gsrc) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(sdst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(gsrc)
               : "memory");
#endif
}

// Closes the thread's copies issued since the last commit into one group.
__device__ __forceinline__ void async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Waits until at most N of the thread's committed groups are in flight.
// Other threads' copies are visible only after a __syncthreads() too.
template <int N>
__device__ __forceinline__ void async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}
#endif  // __CUDACC__

// Raises kernel's limit of dynamic shared memory to bytes (needed above
// 48 KB), once per device; returns the cudaError_t (0 = ok).
template <class Params>
int dynamic_smem_limit(void (*kernel)(Params), int bytes) {
  static bool done[64] = {};
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  if (dev >= 0 && dev < 64 && done[dev]) return 0;
  rc = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (rc == 0 && dev >= 0 && dev < 64) done[dev] = true;
  return rc;
}

// ---- the thread's coordinates in its block ---------------------------------
// What the body's per-cell loops read.  A kernel that runs the body many
// times per launch (the whole-step kernel's face phases, three stages of
// work items) defines COV_OPAQUE_TID before including this header: each
// read is then a volatile register move, which the compiler neither hoists
// nor shares across the runs, so it keeps no per-thread offsets alive
// between them (shared, they spilled 840 B at the 80-register cap and the
// step took 298 instead of 107 us on an H100 80GB HBM3 at 700 W,
// scripts/torch_faces_probe.py).  Everywhere else they are threadIdx's
// own fields.

__device__ __forceinline__ unsigned tid_x() {
#if defined(COV_OPAQUE_TID) && defined(__CUDA_ARCH__)
  unsigned v;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(v));
  return v;
#else
  return threadIdx.x;
#endif
}

__device__ __forceinline__ unsigned tid_y() {
#if defined(COV_OPAQUE_TID) && defined(__CUDA_ARCH__)
  unsigned v;
  asm volatile("mov.u32 %0, %%tid.y;" : "=r"(v));
  return v;
#else
  return threadIdx.y;
#endif
}

// ---- tile geometry --------------------------------------------------------

constexpr int FTX = 32;            // output tile width along alpha (i)
constexpr int FTY = 24;            // output tile height along beta (j)
constexpr int FPB = 3;             // faces per block: a grid of 2 groups
constexpr int NT = BX * BY;        // threads per block (256)
constexpr int WOFF = 2;            // shared column of the tile's column 0
constexpr int WS = FTX + 4;        // shared row stride of a staged window
static_assert(FTX == BX && FTY % BY == 0, "one column per lane");

// The source of field fi at face-local (j, i): the interior q, or an edge
// ghost of the face's routed blocks gsn (6h+2, n) / gwe (n, 6h+2) (field
// fi at rows / columns fi*2h .. fi*2h+2h, S|N and W|E); nullptr at a ghost
// corner or past the hh-deep ghost ring.
__device__ __forceinline__ const float* edge_src(const float* __restrict__ q,
                                                 const float* __restrict__ gsn,
                                                 const float* __restrict__ gwe,
                                                 int fi, int n, int hh, int rw,
                                                 int j, int i) {
  const bool jin = j >= 0 && j < n;
  const bool iin = i >= 0 && i < n;
  if (jin && iin) return q + j * n + i;
  if (iin) {
    if (j < 0 && j >= -hh) return gsn + (fi * 2 * hh + (j + hh)) * n + i;
    if (j >= n && j < n + hh)
      return gsn + (fi * 2 * hh + hh + (j - n)) * n + i;
  } else if (jin) {
    if (i < 0 && i >= -hh) return gwe + j * rw + fi * 2 * hh + (i + hh);
    if (i >= n && i < n + hh) return gwe + j * rw + fi * 2 * hh + hh + (i - n);
  }
  return nullptr;
}

// ---- a tile's regions, one column per lane --------------------------------

// Calls fn(y, x) once for each cell of a ROWS x COLS region of the tile
// (COLS >= BX): the thread's cells (ty + r * BY, tx) of the rows that the
// block's warps cover evenly, with offsets known at compile time, then the
// rest (the last rows and the columns past BX) one cell per thread, in
// one pass where the block has threads enough, else in a loop.
template <int ROWS, int COLS, class F>
__device__ __forceinline__ void for_region(F fn) {
  constexpr int RM = ROWS / BY * BY;            // rows of the even part
  constexpr int BOTTOM = (ROWS - RM) * COLS;    // the last rows
  constexpr int REST = BOTTOM + RM * (COLS - BX);
  static_assert(COLS >= BX, "one column per lane");
#pragma unroll
  for (int r = 0; r < RM / BY; ++r)
    fn(tid_y() + r * BY, (int)tid_x());
  const int t = tid_y() * BX + tid_x();
  if constexpr (REST <= NT) {
    if (REST > 0 && t < REST) {
      if (t < BOTTOM) {
        const int y = t / COLS;
        fn(RM + y, t - y * COLS);
      } else {
        const int u = t - BOTTOM, y = u / (COLS - BX);
        fn(y, BX + u - y * (COLS - BX));
      }
    }
  } else {
    for (int k = t; k < REST; k += NT) {
      if (k < BOTTOM) {
        const int y = k / COLS;
        fn(RM + y, k - y * COLS);
      } else {
        const int u = k - BOTTOM, y = u / (COLS - BX);
        fn(y, BX + u - y * (COLS - BX));
      }
    }
  }
}

// Issues the copies of rows jw .. jw+ROWS-1, columns i0-A .. i0+FTX+A-1 of
// field fi of one face into s (row stride S, column c of the tile at
// s[r * S + OFF + c]; OFF >= A): each cell from edge_src (the interior q
// or the routed ghosts gsn / gwe), 0 where it gives none (ghost corners,
// past the ring, past a ragged tile's edge; with hh = 0 every cell off
// the face).
template <int ROWS, int A, int S = WS, int OFF = WOFF>
__device__ __forceinline__ void stage_field(float* s,
                                            const float* __restrict__ q,
                                            const float* __restrict__ gsn,
                                            const float* __restrict__ gwe,
                                            int fi, int n, int hh, int rw,
                                            int jw, int i0) {
  for_region<ROWS, FTX + 2 * A>([&](int r, int cc) {
    const int c = cc - A;
    float* dst = s + r * S + OFF + c;
    const float* src = edge_src(q, gsn, gwe, fi, n, hh, rw, jw + r, i0 + c);
    if (src != nullptr)
      async_copy4(dst, src);
    else
      *dst = 0.0f;
  });
}

// The h x h ghost corners of one staged field s (rows j0-A .. j0+FTY+A-1,
// columns i0-A .. i0+FTX+A-1; row stride S, tile column c at s[r][OFF +
// c]): _fill(corners=True)'s average of the S/N ghost at the nearest
// interior column and the W/E ghost at the nearest interior row, both in
// the window already.  The cells at most D deep (D <= A, D <= the halo)
// are built; the window holds at most D x D of them at each of the face's
// four corners: thread t < 4 D^2 takes one.
template <int A, int D = A, int S = WS, int OFF = WOFF>
__device__ __forceinline__ void fill_corners(float (*s)[S], int n, int j0,
                                             int i0) {
  const int t = threadIdx.y * BX + threadIdx.x;
  if (t >= 4 * D * D) return;
  const int corner = t / (D * D), e = t - corner * (D * D);
  const int dj = e / D, di = e - dj * D;
  const int j = corner & 1 ? n + dj : -1 - dj;   // N : S
  const int i = corner & 2 ? n + di : -1 - di;   // E : W
  const int r = j - (j0 - A), c = i - i0;        // window row, tile column
  if (r < 0 || r >= FTY + 2 * A || c < -A || c >= FTX + A) return;
  const int ce = (i < 0 ? 0 : n - 1) - i0;       // nearest interior column
  const int re = (j < 0 ? 0 : n - 1) - (j0 - A); // and row
  s[r][OFF + c] = 0.5f * (s[r][OFF + ce] + s[re][OFF + c]);
}

// Issues the copies of the orography on the Bernoulli band of the tile at
// (j0, i0) into wb (cell (ly, lx) at (j0 + ly - 1, i0 + lx - 1)) from bf,
// the (n + 2 hh)^2 frame of a face or a block: rows and columns -1 .. n;
// 0 past them.
__device__ __forceinline__ void stage_band(float (*wb)[FTX + 2],
                                           const float* __restrict__ bf,
                                           int n, int hh, int j0, int i0) {
  const int m = n + 2 * hh;
  for_region<FTY + 2, FTX + 2>([&](int r, int c) {
    const int j = j0 + r - 1, i = i0 + c - 1;
    if (j <= n && i <= n)
      async_copy4(&wb[r][c], bf + (long)(j + hh) * m + i + hh);
    else
      wb[r][c] = 0.0f;
  });
}

// Cell (j, i) of q, the extended array of an n x n output with a hh-deep
// frame (row stride n + 2 hh): a block's ghost-filled frame (B6) or the
// interior of a block around its ghost-free core (B5); nullptr past the
// frame (the ragged last tiles' aprons, which feed no kept output).  The
// sharded tiers' counterpart of edge_src.
__device__ __forceinline__ const float* frame_src(const float* __restrict__ q,
                                                  int n, int hh, int j,
                                                  int i) {
  if (j < -hh || j >= n + hh || i < -hh || i >= n + hh) return nullptr;
  return q + (long)(j + hh) * (n + 2 * hh) + i + hh;
}

// stage_field's counterpart for an extended array q (frame_src): rows jw
// .. jw+ROWS-1, columns i0-A .. i0+FTX+A-1 into s; 0 past the frame.
template <int ROWS, int A>
__device__ __forceinline__ void stage_frame(float* s,
                                            const float* __restrict__ q,
                                            int n, int hh, int jw, int i0) {
  for_region<ROWS, FTX + 2 * A>([&](int r, int cc) {
    const int c = cc - A;
    float* dst = s + r * WS + WOFF + c;
    const float* src = frame_src(q, n, hh, jw + r, i0 + c);
    if (src != nullptr)
      async_copy4(dst, src);
    else
      *dst = 0.0f;
  });
}

// ---- the compact stage: metric terms and one face's tile -----------------

// How stage_face_tile's boundary fluxes take the imposed edge normals.
enum class Seam {
  Prescaled,   // the sym rows as they are (the compact stage's routed rows)
  Frame,       // times the edge sqrtg of the closed-form frame (B4, B6)
  FrameCg,     // as Frame, the rows read through L2 (__ldcg): rows written
               // earlier in the same launch (the whole-step kernel's routes)
  None         // none imposed: a block's ghost-free core (B5)
};

// The sym row value at p, as seam S reads it.
template <Seam S>
__device__ __forceinline__ float sym_value(const float* p) {
  if constexpr (S == Seam::FrameCg)
    return __ldcg(p);
  else
    return *p;
}

// The face-independent terms of the stage on one tile, computed once per
// block with rhs_core_cov's operations: on the Bernoulli band (cell
// (ly, lx) at (j0 + ly - 1, i0 + lx - 1)) the inverse metric g_aa, g_ab,
// g_bb; at the alpha-faces (ly, lf) and beta-faces (lf, lx) the
// xface_metric / yface_metric pair; at the centers inv_sqrtg / d, sqrtg
// and inv_rho.  Entries that no kept output reads are 0.
struct StageMetric {
  float gaa[FTY + 2][FTX + 2], gab[FTY + 2][FTX + 2], gbb[FTY + 2][FTX + 2];
  float xa[FTY][FTX + 1], xb[FTY][FTX + 1];   // fg_aa, fg_ab
  float ya[FTY + 1][FTX], yb[FTY + 1][FTX];   // fg_ab, fg_bb
  float isgd[FTY][FTX], sqrtg[FTY][FTX], irho[FTY][FTX];
};

// One face's staged inputs: h with a 2-deep apron, u_a and u_b with a
// 1-deep one (tile cell (y, x) at h[y + 2][WOFF + x], ua[y + 1][WOFF + x]),
// and the orography on the band (cell (ly, lx) as in StageMetric).
struct StageWindow {
  float h[FTY + 4][WS];
  float ua[FTY + 2][WS];
  float ub[FTY + 2][WS];
  float b[FTY + 2][FTX + 2];
};

// The Bernoulli band and the face fluxes of one face's tile.
struct StageScratch {
  float bern[FTY + 2][FTX + 2];
  float fx[FTY][FTX + 1];
  float fy[FTY + 1][FTX];
};

// The band cell (j, i) holds a value: the face's ring-1 frame without its
// corners.
__device__ __forceinline__ bool band_cell(int n, int j, int i) {
  const bool jin = j >= 0 && j < n, iin = i >= 0 && i < n;
  return j >= -1 && j <= n && i >= -1 && i <= n && (jin || iin);
}

// The inverse metric g_aa, g_ab, g_bb at a band cell with coordinates
// (X, Y) = (x, y).
__device__ __forceinline__ void inverse_metric(float x, float y, float R2,
                                               float& g_aa, float& g_ab,
                                               float& g_bb) {
  const float dxda = 1.0f + x * x;
  const float dydb = 1.0f + y * y;
  const float rho2 = dxda + y * y;
  const float inv_R2dxda = 1.0f / (R2 * dxda);
  const float inv_dydb = 1.0f / dydb;
  g_aa = rho2 * inv_R2dxda;
  g_bb = (rho2 * inv_R2dxda) * (dxda * inv_dydb);
  g_ab = rho2 * ((x * inv_R2dxda) * (y * inv_dydb));
}

// inv_sqrtg / d, sqrtg and inv_rho at a cell centre (x, y).
__device__ __forceinline__ void center_terms(float x, float y, float R2,
                                             float inv_d, float& isgd,
                                             float& sqrtg, float& irho) {
  const float dxda = 1.0f + x * x;
  const float dydb = 1.0f + y * y;
  const float rho2 = dxda + y * y;
  const float inv_rho = rsqrtf(rho2);
  const float inv_rho2 = inv_rho * inv_rho;
  const float sg_row = R2 * dxda;
  sqrtg = (sg_row * dydb) * (inv_rho2 * inv_rho);
  const float inv_sqrtg = ((1.0f / sg_row) * (1.0f / dydb))
                        * (rho2 * rho2 * inv_rho);
  isgd = inv_sqrtg * inv_d;
  irho = inv_rho;
}

// Fills mt for the tile at (j0, i0).  xc, xf (row coordinates) and yc, yf
// (column coordinates) as stage_face_tile takes them.  No barrier: the
// caller's next __syncthreads() publishes mt.
__device__ __forceinline__ void stage_metric(
    StageMetric& mt, const float* __restrict__ xc,
    const float* __restrict__ xf, const float* __restrict__ yc,
    const float* __restrict__ yf, float R2, float inv_d, int n, int hh,
    int j0, int i0) {
  for_region<FTY + 2, FTX + 2>([&](int ly, int lx) {
    const int j = j0 + ly - 1, i = i0 + lx - 1;
    float g_aa = 0.0f, g_ab = 0.0f, g_bb = 0.0f;
    if (band_cell(n, j, i))
      inverse_metric(xc[i + hh], yc[j + hh], R2, g_aa, g_ab, g_bb);
    mt.gaa[ly][lx] = g_aa;
    mt.gab[ly][lx] = g_ab;
    mt.gbb[ly][lx] = g_bb;
  });
  for_region<FTY, FTX + 1>([&](int ly, int lf) {
    const int j = j0 + ly, i = i0 + lf;
    float fa = 0.0f, fb = 0.0f;
    if (j < n && i <= n) xface_metric(xf[i + hh], yc[j + hh], fa, fb);
    mt.xa[ly][lf] = fa;
    mt.xb[ly][lf] = fb;
  });
  for_region<FTY + 1, FTX>([&](int lf, int lx) {
    const int j = j0 + lf, i = i0 + lx;
    float fa = 0.0f, fb = 0.0f;
    if (j <= n && i < n) yface_metric(xc[i + hh], yf[j + hh], fa, fb);
    mt.ya[lf][lx] = fa;
    mt.yb[lf][lx] = fb;
  });
  for_region<FTY, FTX>([&](int ly, int lx) {
    const int j = j0 + ly, i = i0 + lx;
    float isgd = 0.0f, sqrtg = 0.0f, irho = 0.0f;
    if (j < n && i < n)
      center_terms(xc[i + hh], yc[j + hh], R2, inv_d, isgd, sqrtg, irho);
    mt.isgd[ly][lx] = isgd;
    mt.sqrtg[ly][lx] = sqrtg;
    mt.irho[ly][lx] = irho;
  });
}

// The covariant right-hand side (rhs_core_cov) of one face's tile from
// its staged window w and the tile's metric terms mt (both synchronised),
// with the face's sym rows imposed as S says, its coordinates (the tan of
// the centres and left faces along i, xc and xf, and along j, yc and yf;
// a whole face passes its pair twice: the Coriolis term reads the
// centres, a Frame seam's sqrtg the faces too) and frame fz.  w is read
// as a StageWindow (or a type with its members h, ua, ub, b indexed
// alike), mt as a StageMetric (likewise).  For every
// interior cell it calls epi(r, j, i, dh, dua, dub, hc, uac, ubc) with r
// the thread's row index (ly = ty + r * BY, lx = tx) and the cell's
// current values.  Every thread of the block must call it: it
// synchronises once, between the fluxes and the tendencies.
template <Seam S, class W, class Mt, class Epilogue>
__device__ __forceinline__ void stage_face_tile(
    const W& w, const Mt& mt, StageScratch& s,
    const SymRows& sym, const float* __restrict__ xc,
    const float* __restrict__ xf, const float* __restrict__ yc,
    const float* __restrict__ yf, const float* __restrict__ fz,
    const StageConsts& k, int n, int hh, int j0, int i0, Epilogue epi) {
  auto H = [&](int y, int x) { return w.h[y + 2][WOFF + x]; };
  auto UA = [&](int y, int x) { return w.ua[y + 1][WOFF + x]; };
  auto UB = [&](int y, int x) { return w.ub[y + 1][WOFF + x]; };

  // ---- Bernoulli function on the band -------------------------------------
  for_region<FTY + 2, FTX + 2>([&](int ly, int lx) {
    float bern = 0.0f;
    if (band_cell(n, j0 + ly - 1, i0 + lx - 1)) {
      const float va = UA(ly - 1, lx - 1), vb = UB(ly - 1, lx - 1);
      const float uca = mt.gaa[ly][lx] * va + mt.gab[ly][lx] * vb;
      const float ucb = mt.gab[ly][lx] * va + mt.gbb[ly][lx] * vb;
      const float ke = 0.5f * (uca * va + ucb * vb);
      bern = k.gravity * (H(ly - 1, lx - 1) + w.b[ly][lx]) + ke;
    }
    s.bern[ly][lx] = bern;
  });

  // ---- mass fluxes through the alpha-faces (i) and beta-faces (j) -------
  for_region<FTY, FTX + 1>([&](int ly, int lf) {
    const int j = j0 + ly, i = i0 + lf;   // face i: cells i-1 | i
    float flux = 0.0f;
    if (j < n && i <= n) {
      float U;
      if (S != Seam::None && (i == 0 || i == n)) {   // W / E seam
        U = sym_value<S>((i == 0 ? sym.w : sym.e) + j * sym.ws);
        if (S == Seam::Frame || S == Seam::FrameCg)
          U = frame_sqrtg(xf[i + hh], yc[j + hh], k.R2) * U;
      } else {
        const float uba = 0.5f * (UA(ly, lf - 1) + UA(ly, lf));
        const float ubb = 0.5f * (UB(ly, lf - 1) + UB(ly, lf));
        U = mt.xa[ly][lf] * uba + mt.xb[ly][lf] * ubb;
      }
      flux = upwind_flux(U, H(ly, lf - 2), H(ly, lf - 1), H(ly, lf),
                         H(ly, lf + 1));
    }
    s.fx[ly][lf] = flux;
  });
  for_region<FTY + 1, FTX>([&](int lf, int lx) {
    const int j = j0 + lf, i = i0 + lx;   // face j: cells j-1 | j
    float flux = 0.0f;
    if (j <= n && i < n) {
      float U;
      if (S != Seam::None && (j == 0 || j == n)) {   // S / N seam
        U = sym_value<S>((j == 0 ? sym.s : sym.n) + i);
        if (S == Seam::Frame || S == Seam::FrameCg)
          U = frame_sqrtg(xc[i + hh], yf[j + hh], k.R2) * U;
      } else {
        const float vba = 0.5f * (UA(lf - 1, lx) + UA(lf, lx));
        const float vbb = 0.5f * (UB(lf - 1, lx) + UB(lf, lx));
        U = mt.ya[lf][lx] * vba + mt.yb[lf][lx] * vbb;
      }
      flux = upwind_flux(U, H(lf - 2, lx), H(lf - 1, lx), H(lf, lx),
                         H(lf + 1, lx));
    }
    s.fy[lf][lx] = flux;
  });
  __syncthreads();

  // ---- tendencies ---------------------------------------------------------
  const int lx = tid_x();
#pragma unroll
  for (int r = 0; r < FTY / BY; ++r) {
    const int ly = tid_y() + r * BY;
    const int j = j0 + ly, i = i0 + lx;
    if (j >= n || i >= n) continue;
    const float x = xc[i + hh], y = yc[j + hh];
    const float dh = -((s.fx[ly][lx + 1] - s.fx[ly][lx])
                       + (s.fy[ly + 1][lx] - s.fy[ly][lx]))
                   * mt.isgd[ly][lx];
    const float dba = (s.bern[ly + 1][lx + 2] - s.bern[ly + 1][lx])
                    * k.inv2d;
    const float dbb = (s.bern[ly + 2][lx + 1] - s.bern[ly][lx + 1])
                    * k.inv2d;
    const float dub_da = (UB(ly, lx + 1) - UB(ly, lx - 1)) * k.inv2d;
    const float dua_db = (UA(ly + 1, lx) - UA(ly - 1, lx)) * k.inv2d;
    const float rz = ((fz[0] + x * fz[1]) + y * fz[2]) * mt.irho[ly][lx];
    const float absv = (dub_da - dua_db)
                     + (k.two_omega * rz) * mt.sqrtg[ly][lx];
    // The contravariant u at the center, as the band computed it.
    const float va = UA(ly, lx), vb = UB(ly, lx);
    const float g_aa = mt.gaa[ly + 1][lx + 1], g_ab = mt.gab[ly + 1][lx + 1],
                g_bb = mt.gbb[ly + 1][lx + 1];
    const float uca = g_aa * va + g_ab * vb;
    const float ucb = g_ab * va + g_bb * vb;
    const float dua = absv * ucb - dba;
    const float dub = (-absv) * uca - dbb;
    epi(r, j, i, dh, dua, dub, H(ly, lx), va, vb);
  }
}

// ---- the ghost ring of whole extended blocks -------------------------------

// The ghost ring cells of a group's faces that the tile at (j0, i0) owns,
// for the stages that write whole (n + 2 hh)^2 blocks (B8, B13): those
// whose nearest interior cell the tile holds (interior tiles own none),
// the ghost corners with the S and N rows.  The cells (at most 116 per
// face for a corner tile at halo 2) are listed flat over the FPB faces,
// S and N rows first, then W and E columns, so that a block writes them
// in one pass, a thread taking up to two (swe_stage_inkernel.cu's Ring,
// which that kernel keeps for itself).
struct FrameRing {
  int ilo, cols;          // the S/N rows' first column and width
  int ns, nn, nw;         // S, N, W cells per face
  int per_face, count;    // cells per face; all cells of the group

  __device__ __forceinline__ FrameRing(int n, int hh, int j0, int i0) {
    const bool s_edge = j0 == 0, n_edge = j0 + FTY >= n;
    const bool w_edge = i0 == 0, e_edge = i0 + FTX >= n;
    const int rows = (n_edge ? n : j0 + FTY) - j0;   // W/E column height
    ilo = w_edge ? -hh : i0;
    cols = (e_edge ? n + hh : i0 + FTX) - ilo;
    ns = s_edge ? hh * cols : 0;
    nn = n_edge ? hh * cols : 0;
    nw = w_edge ? hh * rows : 0;
    per_face = ns + nn + nw + (e_edge ? hh * rows : 0);
    count = FPB * per_face;
  }

  // Cell kf (< count): its face's place q in the group and its
  // face-local (j, i).
  __device__ __forceinline__ void at(int kf, int n, int hh, int j0, int& q,
                                     int& j, int& i) const {
    q = kf / per_face;
    const int k = kf - q * per_face;
    if (k < ns + nn) {                  // S or N rows
      const int r = k < ns ? k : k - ns, row = r / cols;
      j = k < ns ? -hh + row : n + row;
      i = ilo + r - row * cols;
    } else {                            // W or E columns
      const int r = k - ns - nn;
      const int rr = r < nw ? r : r - nw, row = rr / hh;
      j = j0 + row;
      i = r < nw ? -hh + rr - row * hh : n + rr - row * hh;
    }
  }
};

// ---- the Laplacian's metric terms -------------------------------------------

// The face metric terms of a Laplacian window of LY x LX cells (x-face k
// the left face of column k, y-face k the lower face of row k): every
// float lap_at reads of a cell, at(wy, wx) gathering them.
template <int LY, int LX>
struct LapMetric {
  float xa[LY][LX + 1];   // fg_aa at x-faces
  float xb[LY][LX + 1];   // fg_ab at x-faces
  float ya[LY + 1][LX];   // fg_ab at y-faces
  float yb[LY + 1][LX];   // fg_bb at y-faces
  float isg[LY][LX];      // inv_sqrtg * (1/d) at centers

  __device__ __forceinline__ CellMetric at(int wy, int wx) const {
    return CellMetric{xa[wy][wx], xb[wy][wx], xa[wy][wx + 1], xb[wy][wx + 1],
                      yb[wy][wx], ya[wy][wx], yb[wy + 1][wx], ya[wy + 1][wx],
                      isg[wy][wx]};
  }
};

// The metric terms of the Laplacian window with origin (lj, li) (xc, xf
// of a whole face), on the face's ring-1 window [-1, n]^2 clipped to it
// (0 elsewhere).  No barrier: the caller's next __syncthreads() publishes
// mt.
template <int LY, int LX>
__device__ __forceinline__ void lap_metric(LapMetric<LY, LX>& mt,
                                           const float* __restrict__ xc,
                                           const float* __restrict__ xf,
                                           int n, int hh, int lj, int li,
                                           float R2, float invd) {
  for_region<LY, LX + 1>([&](int wy, int k) {
    const int r = lj + wy, c = li + k;
    float fa = 0.0f, fb = 0.0f;
    if (r >= -1 && r <= n && c >= -1 && c <= n + 1)
      xface_metric(xf[c + hh], xc[r + hh], fa, fb);
    mt.xa[wy][k] = fa;
    mt.xb[wy][k] = fb;
  });
  for_region<LY + 1, LX>([&](int k, int wx) {
    const int r = lj + k, c = li + wx;
    float fa = 0.0f, fb = 0.0f;
    if (r >= -1 && r <= n + 1 && c >= -1 && c <= n)
      yface_metric(xc[c + hh], xf[r + hh], fa, fb);
    mt.ya[k][wx] = fa;
    mt.yb[k][wx] = fb;
  });
  for_region<LY, LX>([&](int wy, int wx) {
    const int r = lj + wy, c = li + wx;
    mt.isg[wy][wx] = (r >= -1 && r <= n && c >= -1 && c <= n)
                         ? center_isg(xc[c + hh], xc[r + hh], R2, invd)
                         : 0.0f;
  });
}

// ---- the sharded tiers' right-hand sides over a stack of ranks ------------
//
// B5 (cov_rhs_interior.cu) and B6 (cov_rhs_local.cu) compute the covariant
// RHS of every rank a tier's process holds in one launch.  A block takes
// one 32 x 24 tile position and a group of at most FPB ranks that hold the
// same block position (iy, ix) on different panels, and so the same
// coordinate rows: the group table lists each group's ranks (-1 past its
// last), and the rows come once per group.  The stacked ranks' fields are
// read as extended arrays (frame_src), each rank's at its own offset.

// The operands of one stacked launch over R ranks in G groups.
struct RanksParams {
  const float* fz;      // (R, 1, 3) face-frame z components (c0, cx, cy)
  const float* xr;      // (G, 1, m) tan of the cell-centre alphas
  const float* xfr;     // (G, 1, m) tan of the left-face alphas
  const float* yc;      // (G, m, 1) tan of the cell-centre betas
  const float* yfc;     // (G, m, 1) tan of the lower-face betas
  const int* groups;    // (G, FPB) the group's ranks, then -1
  const float* h;       // rank r's (m, m) frame at h + r * sh
  const float* u;       // rank r's u_a at u + r * su, u_b m^2 after it
  const float* b;       // rank r's (m, m) orography at b + r * sb
  const float* sym_sn;  // (R, 1, 2, n) S, N edge normals (Seam::Frame)
  const float* sym_we;  // (R, 1, n, 2) W, E edge normals (Seam::Frame)
  float* dh;            // (R, 1, n, n)
  float* du;            // (R, 2, 1, n, n)
  long long sh, su, sb; // rank strides of h, u and b
  int n, halo;          // the output width (B5: the core's) and the halo
  float R2, gravity, two_omega, inv2d, inv_d;
};

struct RanksSmem {
  StageWindow w[2];   // this rank's window and the next one's
  StageMetric mt;
  StageScratch s;
};

// Issues the copies of rank r's window into w (no commit).
__device__ __forceinline__ void stage_rank_window(const RanksParams& p,
                                                  StageWindow& w, int r,
                                                  int j0, int i0) {
  const int n = p.n, hh = p.halo, m = n + 2 * hh;
  const float* u = p.u + r * p.su;
  stage_frame<FTY + 4, 2>(&w.h[0][0], p.h + r * p.sh, n, hh, j0 - 2, i0);
  stage_frame<FTY + 2, 1>(&w.ua[0][0], u, n, hh, j0 - 1, i0);
  stage_frame<FTY + 2, 1>(&w.ub[0][0], u + (long)m * m, n, hh, j0 - 1, i0);
  stage_band(w.b, p.b + r * p.sb, n, hh, j0, i0);
}

// The ranks of group g on the tile at (j0, i0): the group's metric terms
// once, then each rank's tile from its window while the next rank's is
// staged.
template <Seam S>
__device__ __forceinline__ void rhs_group(const RanksParams& p, RanksSmem& sm,
                                          int g, int j0, int i0) {
  const int n = p.n, hh = p.halo, m = n + 2 * hh;
  const long nn = (long)n * n;
  const StageConsts k{p.R2, p.gravity, p.two_omega, p.inv2d, p.inv_d};
  const int* ranks = p.groups + g * FPB;
  const long rows = (long)g * m;   // the group's block position
  const float* xr = p.xr + rows;
  const float* xfr = p.xfr + rows;
  const float* yc = p.yc + rows;
  const float* yfc = p.yfc + rows;

  stage_rank_window(p, sm.w[0], ranks[0], j0, i0);
  async_commit();
  stage_metric(sm.mt, xr, xfr, yc, yfc, p.R2, p.inv_d, n, hh, j0, i0);

  for (int q = 0; q < FPB; ++q) {
    const int r = ranks[q];
    if (r < 0) break;
    const int cur = q & 1;
    const int next = q + 1 < FPB ? ranks[q + 1] : -1;
    if (next >= 0) {
      stage_rank_window(p, sm.w[cur ^ 1], next, j0, i0);
      async_commit();
      async_wait<1>();
    } else {
      async_wait<0>();
    }
    __syncthreads();   // this rank's window (and, first, mt) complete

    const StageWindow& w = sm.w[cur];
    SymRows sym{nullptr, nullptr, nullptr, nullptr, 0};
    if (S == Seam::Frame) {
      const float* sn = p.sym_sn + 2L * r * n;
      const float* we = p.sym_we + 2L * r * n;
      sym = SymRows{sn, sn + n, we, we + 1, 2};
    }
    float* dh = p.dh + r * nn;
    float* du = p.du + 2 * r * nn;
    stage_face_tile<S>(
        w, sm.mt, sm.s, sym, xr, xfr, yc, yfc, p.fz + 3 * r, k, n, hh, j0,
        i0,
        [&](int, int j, int i, float dhv, float dua, float dub, float,
            float, float) {
          const long c = (long)j * n + i;
          dh[c] = dhv;
          du[c] = dua;
          du[nn + c] = dub;
        });
    __syncthreads();   // w and the scratch are free for the next rank
  }
}

}  // namespace cov
