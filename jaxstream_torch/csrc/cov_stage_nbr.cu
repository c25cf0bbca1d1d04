// One SSPRK3 stage of the covariant shallow-water equations over plain
// extended fields, each face filling its ghosts from its neighbours'
// interiors: the Hopper (sm_90a) kernel of jaxstream_torch's
// neighbour-read stepper (no router, no strip carry).
//
// Replaces the Pallas TPU kernel make_cov_stage_nbr
// (jaxstream/experiments/swe_cov_nbr.py:127, pallas_call at :404).  The
// plain PyTorch version of the same function is
// jaxstream_torch.experiments.swe_cov_nbr.cov_stage_nbr_reference; the
// kernel reproduces its operations in its order (built with
// -fmad=false, so every multiply and add rounds separately, as
// PyTorch's do).
//
// What it computes, per face f:
//   frame    each of h, u_a, u_b is its whole input block (6, m, m) with
//            the edge ghosts read from the neighbour face's interior: the
//            ghost at canonical depth d (0 nearest the edge) and along-
//            edge index k of edge e is the neighbour's cell at depth d
//            from its edge, along index k, or n-1-k where the pair is
//            reversed.  u is rotated into this face's basis by the two
//            T entries of the ghost slot (the placed tables T_sn
//            (4, 6, 2, h, n) and T_we (4, 6, 2, n, h)).  The ghost
//            corners stay the input's.
//   sym      the symmetrized edge normal at each boundary face, from
//            both panels' edge-adjacent rows: each panel's local normal
//            m0 ub0 + m1 ub1 (ub the mean of its interior row and its
//            rotated ghost row, m the closed-form edge-metric rows
//            (2, 4, n)), then the pair average.  Both faces of an edge
//            evaluate the same expression on the same operands, so their
//            edge fluxes agree bit for bit and mass stays conserved.  Not
//            prescaled: the fluxes multiply them by the edge sqrtg.
//   out      as cov_stage_inkernel.cu: the whole (m, m) block is val =
//            a*y0 + b*frame (stage 1: the frame), its interior val +
//            b*dt*tend; every cell is written once.
//
// Bound.  Stage 1 reads h, u_a, u_b and b (4 x 6 m^2 floats) and writes
// h, u_a, u_b (3 x 6 m^2): at C384 (m = 388) 25.29 MB -> 7.55 us at
// 3.35 TB/s; stages 2-3 also read h0, u0: 36.13 MB -> 10.78 us.  The
// float32 arithmetic (~137 flops per cell) is ~1.8 us: bound by memory.
//
// Design.  cov_stage_inkernel.cu's (B8's) faces-in-block body: a block
// of 256 threads takes one 32 x 24 tile position and a group of three
// faces, a grid of (ceil(n/32), ceil(n/24), 2) = 384 blocks at C384; only
// the frame's ghost cells and the sym rows differ.  The neighbour of each
// (face, edge) and each edge's pair are small integer tables in the
// kernel's parameters (constant memory).  The block
//   1. loads its first pass of ring cells (FrameRing, all three faces in
//      one flat list, one cell a thread: h and the neighbour's u with the
//      slot's four T entries), the operands of the sym rows of its
//      group's faces on the tile's face edges (both panels' edge-adjacent
//      u and T entries; at most 3 faces x 4 edges x 32 entries) and the
//      first face's u ghosts, then issues the cp.async copies of the first
//      face's window: h with a 2-deep apron (its edge ghosts straight from
//      the neighbour's interior: h needs no rotation), u_a and u_b with a
//      1-deep one (their ghost cells skipped), b on the Bernoulli band;
//      then rotates and stores the ring cells (y0 and the edge-metric rows
//      read there), the sym rows (into shared memory) and the first
//      face's u ghosts (into its window); the rest of the ring (a corner
//      tile holds 348 cells at C384) follows in further passes;
//   2. computes the tile's metric terms once into shared memory;
//   3. per face of its group: issues the next face's window into the
//      other buffer and loads the next face's u ghosts into registers
//      (each thread one cell and component: the neighbour's two u
//      components and the slot's two T entries), loads the combine's y0,
//      waits for this face's window, runs stage_face_tile<Seam::Frame>
//      with the face's sym rows from shared memory, the combine and the
//      whole-block stores; then rotates the next face's ghosts, in the
//      plain version's order, into the other buffer.
// Occupancy: 74 112 B of dynamic shared memory (B8's 72 576 and the sym
// rows 1 536) and __launch_bounds__(256, 3): 3 blocks per SM, <= 80
// registers; one wave of 384 blocks.

#include "cov_faces.cuh"

namespace {

using namespace cov;

// Edge slots, the order of the tables: S, N, W, E.
constexpr int SLOT_S = 0, SLOT_N = 1, SLOT_W = 2, SLOT_E = 3;

struct Params {
  const float* h0;   // (6, m, m) stage base, read only if with_y0
  const float* u0;   // (2, 6, m, m)
  const float* hc;   // (6, m, m) current stage
  const float* uc;   // (2, 6, m, m)
  const float* b;    // (6, m, m) orography, ghosts filled
  const float* tsn;  // (4, 6, 2, h, n) rotations at the S/N ghost slots
  const float* twe;  // (4, 6, 2, n, h) rotations at the W/E ghost slots
  const float* met;  // (2, 4, n) edge-metric rows m0, m1 per slot
  const float* xc;   // (m,) tan of the cell-center coordinates
  const float* xf;   // (m,) tan of the left-face coordinates
  const float* fz;   // (6, 3) face-frame z components (c0, cx, cy)
  float* ho;         // (6, m, m)
  float* uo;         // (2, 6, m, m)
  int conn[6][4][3];  // (face, slot) -> neighbour face, its slot, reversed
  int pair[6][4][5];  // (face, slot) -> link face, link slot, back face,
                      // back slot, is_link
  int n, halo, with_y0;
  float R2, gravity, two_omega, inv2d, inv_d, a, bcoef, g_dt;
};

struct Smem {
  StageWindow w[2];         // this face's window and the next one's
  StageMetric mt;
  StageScratch s;
  float sym[FPB][4][FTX];   // the group's sym rows along the tile, S N W E
};

// The u_a and u_b arrays' offsets in a StageWindow, in floats.
constexpr int UA_OFF = (FTY + 4) * WS;
constexpr int UB_OFF = UA_OFF + (FTY + 2) * WS;

// The outward sign of a slot's edge: -1 at S and W, +1 at N and E.
__device__ __forceinline__ float out_sign(int s) {
  return (s == SLOT_N || s == SLOT_E) ? 1.0f : -1.0f;
}

// Interior cell (j, i) (face-local) of face g at canonical depth d from
// its edge s and along-edge index k.
__device__ __forceinline__ long src_cell(int g, int s, int d, int k, int n,
                                         int hh) {
  const int m = n + 2 * hh;
  int j, i;
  if (s == SLOT_S) { j = d; i = k; }
  else if (s == SLOT_N) { j = n - 1 - d; i = k; }
  else if (s == SLOT_W) { j = k; i = d; }
  else { j = k; i = n - 1 - d; }
  return (long)g * m * m + (long)(j + hh) * m + i + hh;
}

// T entry r of face f's ghost slot at edge s, canonical depth d, along k.
__device__ __forceinline__ float t_at(const Params& p, int r, int f, int s,
                                      int d, int k) {
  const int n = p.n, hh = p.halo;
  const long blk = ((long)(r * 6 + f) * 2 + (s & 1)) * hh * n;
  if (s == SLOT_S) return p.tsn[blk + (long)(hh - 1 - d) * n + k];
  if (s == SLOT_N) return p.tsn[blk + (long)d * n + k];
  if (s == SLOT_W) return p.twe[blk + (long)k * hh + hh - 1 - d];
  return p.twe[blk + (long)k * hh + d];
}

// An edge ghost's slot, canonical depth and along-edge index.
struct GhostAt {
  int s, d, k;
};

// The edge ghost (j, i) of a face: exactly one of j, i past the face.
__device__ __forceinline__ GhostAt ghost_at(int n, int j, int i) {
  if (j < 0) return GhostAt{SLOT_S, -1 - j, i};
  if (j >= n) return GhostAt{SLOT_N, j - n, i};
  if (i < 0) return GhostAt{SLOT_W, -1 - i, j};
  return GhostAt{SLOT_E, i - n, j};
}

// The neighbour's interior cell that face f's ghost g reads.
__device__ __forceinline__ long nbr_cell(const Params& p, int f, GhostAt g) {
  const int* c = p.conn[f][g.s];
  return src_cell(c[0], c[1], g.d, c[2] ? p.n - 1 - g.k : g.k, p.n, p.halo);
}

// ---- the window ---------------------------------------------------------

// Issues the copies of rows jw .. jw+ROWS-1, columns i0-A .. i0+FTX+A-1
// of field fi's frame of face f into s (row stride WS): the face's own
// cells (interior and ghost corners) and, for h, its edge ghosts from the
// neighbour's interior; 0 past the frame.  u's edge ghosts next to the
// face are left to ghost_store, those deeper (a ragged last tile's apron,
// which feeds no kept output) are 0.
template <int ROWS, int A>
__device__ __forceinline__ void stage_nbr(float* s, const Params& p, int fi,
                                          int f, int jw, int i0) {
  const int n = p.n, hh = p.halo, m = n + 2 * hh;
  const long mm = (long)m * m;
  const float* q = (fi == 0 ? p.hc : p.uc) + (fi == 2 ? 6 + f : f) * mm;
  for_region<ROWS, FTX + 2 * A>([&](int r, int cc) {
    const int c = cc - A, j = jw + r, i = i0 + c;
    float* dst = s + r * WS + WOFF + c;
    if (j < -hh || j >= n + hh || i < -hh || i >= n + hh) {
      *dst = 0.0f;
      return;
    }
    const bool jin = j >= 0 && j < n, iin = i >= 0 && i < n;
    if (jin == iin)
      async_copy4(dst, q + (j + hh) * m + i + hh);
    else if (fi == 0)
      async_copy4(dst, p.hc + nbr_cell(p, f, ghost_at(n, j, i)));
    else if (j < -1 || j > n || i < -1 || i > n)
      *dst = 0.0f;
  });
}

// Issues the copies of face f's window into w (no commit).
__device__ __forceinline__ void stage_window(const Params& p, StageWindow& w,
                                             int f, int j0, int i0) {
  const int n = p.n, hh = p.halo, m = n + 2 * hh;
  stage_nbr<FTY + 4, 2>(&w.h[0][0], p, 0, f, j0 - 2, i0);
  stage_nbr<FTY + 2, 1>(&w.ua[0][0], p, 1, f, j0 - 1, i0);
  stage_nbr<FTY + 2, 1>(&w.ub[0][0], p, 2, f, j0 - 1, i0);
  stage_band(w.b, p.b + (long)f * m * m, n, hh, j0, i0);
}

// The u window's edge ghost cells (the 1-deep apron past the face edges,
// the same cells on every face of the group): S, N rows of columns ib ..
// ib+ncols-1, W, E columns of rows jb .. jb+nrows-1.  Each gives two
// items, u_a and u_b, one a thread.
struct UGhosts {
  int ib, ncols, jb, nrows, cs, cn, cw, cells;

  __device__ __forceinline__ UGhosts(int n, int j0, int i0) {
    ib = i0 > 0 ? i0 - 1 : 0;
    ncols = (i0 + FTX < n - 1 ? i0 + FTX : n - 1) - ib + 1;
    jb = j0 > 0 ? j0 - 1 : 0;
    nrows = (j0 + FTY < n - 1 ? j0 + FTY : n - 1) - jb + 1;
    cs = j0 == 0 ? ncols : 0;
    cn = j0 + FTY >= n ? ncols : 0;
    cw = i0 == 0 ? nrows : 0;
    cells = cs + cn + cw + (i0 + FTX >= n ? nrows : 0);
  }
};
static_assert(2 * (2 * (FTX + 2) + 2 * (FTY + 2)) <= NT,
              "one u ghost item per thread");

// A thread's u ghost item: the neighbour's u components, the slot's two T
// entries of the item's component, and its place in a StageWindow (in
// floats; -1: none).
struct GhostItem {
  float r0, r1, ta, tb;
  int dst;
};

// Loads the thread's u ghost item of face f.
__device__ __forceinline__ void ghost_load(const Params& p, const UGhosts& gu,
                                           int f, int j0, int i0,
                                           GhostItem& g) {
  const int n = p.n, m = n + 2 * p.halo;
  const int t = threadIdx.y * BX + threadIdx.x;
  g.dst = -1;
  if (t >= 2 * gu.cells) return;
  const int comp = t >= gu.cells ? 1 : 0;
  int c = t - comp * gu.cells, j, i;
  if (c < gu.cs) {
    j = -1;
    i = gu.ib + c;
  } else if ((c -= gu.cs) < gu.cn) {
    j = n;
    i = gu.ib + c;
  } else if ((c -= gu.cn) < gu.cw) {
    i = -1;
    j = gu.jb + c;
  } else {
    i = n;
    j = gu.jb + c - gu.cw;
  }
  const GhostAt a = ghost_at(n, j, i);
  const long src = nbr_cell(p, f, a);
  g.r0 = p.uc[src];
  g.r1 = p.uc[6L * m * m + src];
  g.ta = t_at(p, 2 * comp, f, a.s, 0, a.k);
  g.tb = t_at(p, 2 * comp + 1, f, a.s, 0, a.k);
  g.dst = (comp ? UB_OFF : UA_OFF) + (j - j0 + 1) * WS + WOFF + i - i0;
}

// The rotated ghost into window w (the plain version's T r0 + T' r1).
__device__ __forceinline__ void ghost_store(StageWindow& w,
                                            const GhostItem& g) {
  if (g.dst >= 0)
    reinterpret_cast<float*>(&w)[g.dst] = g.ta * g.r0 + g.tb * g.r1;
}

// ---- the ghost ring -------------------------------------------------------

// A thread's ring cell of one pass: h and u at the cell's source (the
// neighbour's interior at an edge ghost, the face's own block at a
// corner) and the slot's T entries (edge ghosts).  One cell a thread
// (two passes for a corner tile at C384): B8's two cells a thread, with
// the sym rows' operands beside them, spilled 84 B at the 80-register cap
// (~1.6 us slower per launch on an H100 80GB HBM3 at 700 W,
// scripts/torch_faces_probe.py); y0 is loaded by the store for the same
// reason.
struct RingCell {
  float v[3], t[4];
  long cell;   // offset in the (m, m) block; -1: none
  int face;
  bool edge;
};

// Issues the loads of the thread's ring cell k0 + t.
__device__ __forceinline__ void ring_load(const Params& p,
                                          const FrameRing& g, int f0,
                                          int j0, int k0, RingCell& rc) {
  const int n = p.n, hh = p.halo, m = n + 2 * hh;
  const long mm = (long)m * m;
  const int kf = k0 + threadIdx.y * BX + threadIdx.x;
  rc.cell = -1;
  if (kf >= g.count) return;
  int q, j, i;
  g.at(kf, n, hh, j0, q, j, i);
  const int f = f0 + q;
  rc.face = f;
  rc.cell = (long)(j + hh) * m + i + hh;
  rc.edge = (j >= 0 && j < n) != (i >= 0 && i < n);
  long src = f * mm + rc.cell;   // a ghost corner: the input's own
  if (rc.edge) {
    const GhostAt a = ghost_at(n, j, i);
    src = nbr_cell(p, f, a);
#pragma unroll
    for (int r = 0; r < 4; ++r) rc.t[r] = t_at(p, r, f, a.s, a.d, a.k);
  }
  rc.v[0] = p.hc[src];
  rc.v[1] = p.uc[src];
  rc.v[2] = p.uc[6 * mm + src];
}

// Stores a*y0 + b*frame (stage 1: the frame) at the cell ring_load
// loaded, u rotated at an edge ghost.
__device__ __forceinline__ void ring_store(const Params& p,
                                           const RingCell& rc) {
  if (rc.cell < 0) return;
  const long mm = (long)(p.n + 2 * p.halo) * (p.n + 2 * p.halo);
  const float* v = rc.v;
  const float* T = rc.t;
  const float fr[3] = {v[0], rc.edge ? T[0] * v[1] + T[1] * v[2] : v[1],
                       rc.edge ? T[2] * v[1] + T[3] * v[2] : v[2]};
#pragma unroll
  for (int fi = 0; fi < 3; ++fi) {
    const long c = (fi == 2 ? 6 + rc.face : rc.face) * mm + rc.cell;
    (fi == 0 ? p.ho : p.uo)[c] =
        p.with_y0 ? p.a * (fi == 0 ? p.h0 : p.u0)[c] + p.bcoef * fr[fi]
                  : fr[fi];
  }
}

// ---- the sym rows -----------------------------------------------------------

// The operands of one panel's local normal at its edge s, along k: the
// neighbour's edge-adjacent u (r0, r1), the depth-0 T entries of the
// slot, the panel's own edge-adjacent u (o0, o1); the edge-metric rows
// are read by local_normal (registers, as for the ring's y0).
struct NormalIn {
  float r0, r1, t[4], o0, o1;
  int s, k;
};

__device__ __forceinline__ void normal_load(const Params& p, int f, int s,
                                            int k, NormalIn& x) {
  const int n = p.n, hh = p.halo;
  const long mm = (long)(n + 2 * hh) * (n + 2 * hh);
  const int* c = p.conn[f][s];
  const long src = src_cell(c[0], c[1], 0, c[2] ? n - 1 - k : k, n, hh);
  x.r0 = p.uc[src];
  x.r1 = p.uc[6 * mm + src];
#pragma unroll
  for (int r = 0; r < 4; ++r) x.t[r] = t_at(p, r, f, s, 0, k);
  const long own = src_cell(f, s, 0, k, n, hh);
  x.o0 = p.uc[own];
  x.o1 = p.uc[6 * mm + own];
  x.s = s;
  x.k = k;
}

// m0 ub0 + m1 ub1 with ub the mean of the rotated edge-adjacent ghost and
// the panel's own edge-adjacent cell.
__device__ __forceinline__ float local_normal(const Params& p,
                                              const NormalIn& x) {
  const float gi0 = x.t[0] * x.r0 + x.t[1] * x.r1;
  const float gi1 = x.t[2] * x.r0 + x.t[3] * x.r1;
  const float ub0 = 0.5f * (gi0 + x.o0);
  const float ub1 = 0.5f * (gi1 + x.o1);
  return p.met[x.s * p.n + x.k] * ub0 + p.met[(4 + x.s) * p.n + x.k] * ub1;
}

// The sym entries of the tile: for each face of the group, the tile's
// columns on the S and N edges and rows on the W and E edges it lies on.
struct SymSpan {
  int len[4];
  int per_face, count;

  __device__ __forceinline__ SymSpan(int n, int j0, int i0) {
    const bool on[4] = {j0 == 0, j0 + FTY >= n, i0 == 0, i0 + FTX >= n};
    const int cols = n - i0 < FTX ? n - i0 : FTX;
    const int rows = n - j0 < FTY ? n - j0 : FTY;
    per_face = 0;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      len[s] = on[s] ? (s < 2 ? cols : rows) : 0;
      per_face += len[s];
    }
    count = FPB * per_face;
  }
};

// One sym entry's operands: both panels' local normals of the edge pair.
struct SymPass {
  NormalIn l, b;
  int f, s, dst;   // the face, its slot; the entry in Smem::sym (-1: none)
};

// Loads the operands of the thread's sym entry e0 + t (sym_normal of
// face f at slot s, along k: the link's normal at kk, the back's at the
// matching, reversed where the pair is, index).
__device__ __forceinline__ void sym_load(const Params& p, const SymSpan& sp,
                                         int f0, int j0, int i0, int e0,
                                         SymPass& x) {
  const int n = p.n;
  const int e = e0 + threadIdx.y * BX + threadIdx.x;
  x.dst = -1;
  if (e >= sp.count) return;
  const int q = e / sp.per_face;
  int l = e - q * sp.per_face, s = 0;
  if (l >= sp.len[0]) {   // (constant indices: the span stays in registers)
    l -= sp.len[0];
    s = 1;
    if (l >= sp.len[1]) {
      l -= sp.len[1];
      s = 2;
      if (l >= sp.len[2]) {
        l -= sp.len[2];
        s = 3;
      }
    }
  }
  const int f = f0 + q, k = (s < 2 ? i0 : j0) + l;
  const int* pr = p.pair[f][s];
  const bool rev = p.conn[pr[0]][pr[1]][2] != 0;
  const int kk = (pr[4] || !rev) ? k : n - 1 - k;
  normal_load(p, pr[0], pr[1], kk, x.l);
  normal_load(p, pr[2], pr[3], rev ? n - 1 - kk : kk, x.b);
  x.f = f;
  x.s = s;
  x.dst = (q * 4 + s) * FTX + l;
}

// The pair average of the loaded normals, signed for face f, into sm.sym.
__device__ __forceinline__ void sym_store(const Params& p, Smem& sm,
                                          const SymPass& x) {
  if (x.dst < 0) return;
  const int* pr = p.pair[x.f][x.s];
  const float sga = out_sign(pr[1]), sgb = out_sign(pr[3]);
  const float nl = local_normal(p, x.l);
  const float nb = local_normal(p, x.b);
  const float avg = 0.5f * (sga * nl - sgb * nb);
  (&sm.sym[0][0][0])[x.dst] = pr[4] ? sga * avg : sgb * (-avg);
}

// ---- the stage ---------------------------------------------------------------

// The three faces of the block's group on one tile position.
__device__ __forceinline__ void stage_faces(const Params& p, Smem& sm,
                                            int f0, int j0, int i0) {
  const int n = p.n, hh = p.halo, m = n + 2 * hh;
  const long mm = (long)m * m;
  const int lx = threadIdx.x;
  const StageConsts k{p.R2, p.gravity, p.two_omega, p.inv2d, p.inv_d};
  const FrameRing ring(n, hh, j0, i0);
  const SymSpan span(n, j0, i0);
  const UGhosts gu(n, j0, i0);
  // The ring's first pass, the sym rows' operands and the first face's u
  // ghosts: their loads ahead of the first window's copies (all blocks
  // issue their first window at once, and loads issued after those wait
  // behind them), their stores after.
  RingCell rp;
  SymPass sp;
  GhostItem gq;
  ring_load(p, ring, f0, j0, 0, rp);
  sym_load(p, span, f0, j0, i0, 0, sp);
  ghost_load(p, gu, f0, j0, i0, gq);
  stage_window(p, sm.w[0], f0, j0, i0);
  async_commit();
  ring_store(p, rp);
  sym_store(p, sm, sp);
  ghost_store(sm.w[0], gq);
  for (int k0 = NT; k0 < ring.count; k0 += NT) {
    ring_load(p, ring, f0, j0, k0, rp);
    ring_store(p, rp);
  }
  for (int e0 = NT; e0 < span.count; e0 += NT) {           // small n only
    sym_load(p, span, f0, j0, i0, e0, sp);
    sym_store(p, sm, sp);
  }
  stage_metric(sm.mt, p.xc, p.xf, p.xc, p.xf, p.R2, p.inv_d, n, hh, j0, i0);

  for (int q = 0; q < FPB; ++q) {
    const int f = f0 + q, cur = q & 1;
    if (q + 1 < FPB) {
      stage_window(p, sm.w[cur ^ 1], f + 1, j0, i0);
      async_commit();
      ghost_load(p, gu, f + 1, j0, i0, gq);
    }
    // The combine's y0 at the thread's cells, loaded ahead of the
    // arithmetic.
    float y0[FTY / BY][3] = {};
    if (p.with_y0) {
#pragma unroll
      for (int r = 0; r < FTY / BY; ++r) {
        const int j = j0 + threadIdx.y + r * BY, i = i0 + lx;
        if (j < n && i < n) {
          const long c = f * mm + (long)(j + hh) * m + i + hh;
          y0[r][0] = p.h0[c];
          y0[r][1] = p.u0[c];
          y0[r][2] = p.u0[6 * mm + c];
        }
      }
    }
    if (q + 1 < FPB)
      async_wait<1>();
    else
      async_wait<0>();
    __syncthreads();   // this face's window (and, first, mt, sym) complete

    const StageWindow& w = sm.w[cur];
    // The sym rows indexed by the face's along-edge index, as
    // stage_face_tile reads them; only this tile's entries are read.
    const SymRows rows{&sm.sym[q][0][0] - i0, &sm.sym[q][1][0] - i0,
                       &sm.sym[q][2][0] - j0, &sm.sym[q][3][0] - j0, 1};
    stage_face_tile<Seam::Frame>(
        w, sm.mt, sm.s, rows, p.xc, p.xf, p.xc, p.xf, p.fz + 3 * f, k, n,
        hh, j0, i0,
        [&](int r, int j, int i, float dh, float dua, float dub, float hcv,
            float uav, float ubv) {
          const long c = f * mm + (long)(j + hh) * m + i + hh;
          p.ho[c] = combine(p.with_y0, p.a, p.bcoef, p.g_dt, y0[r][0], hcv,
                            dh);
          p.uo[c] = combine(p.with_y0, p.a, p.bcoef, p.g_dt, y0[r][1], uav,
                            dua);
          p.uo[6 * mm + c] = combine(p.with_y0, p.a, p.bcoef, p.g_dt,
                                     y0[r][2], ubv, dub);
        });
    if (q + 1 < FPB) ghost_store(sm.w[cur ^ 1], gq);
    __syncthreads();   // w and the scratch are free for the next face
  }
}

__global__ void __launch_bounds__(NT, 3) cov_stage_nbr_kernel(const Params p) {
  extern __shared__ float smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  stage_faces(p, sm, blockIdx.z * FPB, blockIdx.y * FTY, blockIdx.x * FTX);
}

}  // namespace

// Launches one stage on `stream`; returns the cudaError_t of the shared
// memory attribute or of the launch (0 = ok).  with_y0 == 0: frame +
// g_dt*L (stage 1); with_y0 != 0: (a*y0 + b*frame) + g_dt*L (stages 2-3;
// h0/u0 read only then).  All tensors float32, contiguous, in the layouts
// of Params; conn (6, 4, 3) and pair (6, 4, 5) are host int32 arrays,
// copied into the launch's parameters.
extern "C" int cov_stage_nbr_f32(
    const float* h0, const float* u0, const float* hc, const float* uc,
    const float* b_ext, const float* tsn, const float* twe,
    const float* met, const float* xc, const float* xf, const float* fz,
    float* ho, float* uo, const int* conn, const int* pair, int n, int halo,
    int with_y0, float R2, float gravity, float two_omega, float inv2d,
    float inv_d, float a, float b, float g_dt, void* stream) {
  Params p{h0, u0, hc, uc, b_ext, tsn, twe, met, xc, xf, fz, ho, uo, {}, {},
           n, halo, with_y0, R2, gravity, two_omega, inv2d, inv_d, a, b,
           g_dt};
  for (int f = 0; f < 6; ++f)
    for (int s = 0; s < 4; ++s) {
      for (int c = 0; c < 3; ++c) p.conn[f][s][c] = conn[(f * 4 + s) * 3 + c];
      for (int c = 0; c < 5; ++c) p.pair[f][s][c] = pair[(f * 4 + s) * 5 + c];
    }
  const int rc = dynamic_smem_limit(cov_stage_nbr_kernel, sizeof(Smem));
  if (rc != 0) return rc;
  const dim3 grid((n + FTX - 1) / FTX, (n + FTY - 1) / FTY, 6 / FPB);
  const dim3 block(BX, BY);
  const size_t smem = sizeof(Smem);
  cov_stage_nbr_kernel<<<grid, block, smem,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
