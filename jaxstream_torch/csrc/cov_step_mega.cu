// One whole SSPRK3 step of the covariant shallow-water equations over the
// compact carry, routes included, in one cooperative launch: the Hopper
// (sm_90a) kernel of jaxstream_torch's whole-step stepper.
//
// Replaces the Pallas TPU kernel make_fused_ssprk3_cov_mega
// (jaxstream/experiments/swe_mega.py:131, pallas_call at :344).  The
// plain PyTorch version of the same function is
// jaxstream_torch.experiments.swe_mega.cov_mega_step_reference; the
// kernel reproduces its operations in its order (built with
// -fmad=false, so every multiply and add rounds separately, as
// PyTorch's do).
//
// What it computes: three times
//   route    from the stage's boundary strips sn (6, 6h, n) / we (6, n,
//            6h), the routed ghosts gsn (6, 6h+2, n) / gwe (6, n, 6h+2)
//            of the split router (jaxstream_torch.ops.cuda.swe_cov.
//            _SplitRoute): a static row gather (idx, into [sn ; we^T ;
//            their lane flips]), the 2 x 2 covariant rotations (T_sn,
//            T_we) and the pair average of the edge normals, not
//            prescaled;
//   faces    the compact stage on every tile: ghosts from gsn / gwe,
//            rhs_core_cov with the un-prescaled sym rows (the tile
//            multiplies them by the closed-form edge sqrtg) and h's face
//            states by the launch's reconstruction (PLR with one of the
//            five limiters, or PPM at halo >= 3), the combine
//            (A y0 + B cur) + C tend with the stage's row of the float32
//            table AB, and the new boundary strips.
//
// Design.  The TPU kernel runs a grid of 3 x (1 router + 6 faces) steps
// in order with the whole state in VMEM.  An H100 runs blocks
// concurrently, and 10.6 MB of state does not fit in shared memory, so
// here the state stays in global memory (L2 holds it: 50 MB) and the
// phases are separated by grid-wide barriers: one cooperative launch of
// as many 256-thread blocks as can be resident at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM count, 3 x 132
// = 396 on the H100), three rounds of route -> barrier -> faces.  A
// route phase gives each thread routed elements (one ghost or sym value
// each, computed straight from the strips: no barrier inside the
// router).  A face phase is the compact stage's faces-in-block body
// (cov_faces.cuh, as cov_stage.cu): a work item is one 32 x 24 tile
// position and a group of three faces, 12 x 16 x 2 = 384 items at C384,
// so each face phase is one pass of the grid; a block loops over items
// (t += gridDim.x), so a card with fewer slots still runs.  Per item the
// block computes the tile's metric terms (StageMetric) into shared
// memory and then, per face, stages the next face's window while it
// computes this one's.  The metric is the same for all faces and all
// three stages: a block that keeps one item through the launch (gridDim
// >= items) computes it once, before stage 1, and keeps it in shared
// memory through the barriers; a block that takes more than one item
// recomputes it per item.  A tile's apron reads its neighbours' cells, so
// the faces may not overwrite their input: stage 1 writes y0 -> out,
// stage 2 out -> B, stage 3 B -> out.  The strips need one buffer (the
// router reads them before the next face phase writes them).
//
// Load paths.  The L1 and the read-only cache are not kept coherent with
// other SMs' writes inside a launch, so what the launch writes is read
// through L2 only:
//   windows   (the stage inputs ho / uo and bh / bu, and y0 for stage 1,
//             with the routed ghosts gsn / gwe): each window row's body,
//             tile columns 0 .. 31, in 16-byte cp.async.cg copies (L2
//             only) where the row is an interior or S/N ghost row wholly
//             inside the face; the apron columns (and W/E ghosts) as one
//             register-staged __ldcg per thread, issued with the copies one
//             face ahead and stored into the buffer after this face's
//             arithmetic; ragged tiles and misaligned operands cell by cell
//             with __ldcg;
//   sym rows  (gsn / gwe's last rows) with __ldcg in the fluxes
//             (Seam::FrameCg);
//   strips    (sno / weo, the routers' input from stage 2 on) with __ldcg;
//   b, y0     (never written in the launch: the orography band by
//             cp.async.ca, as cov_stage.cu; the epilogue's y0, loaded
//             before the face's arithmetic) through L1;
//   tables    (idx, T_sn, T_we, met, xc, xf, fz) plain loads.
// The 16-byte copies need 16-byte aligned rows (n % 4 == 0 and aligned
// operands, checked by the host: `vec`) and destinations: the windows
// start 8 bytes past a 16-byte boundary, so tile column 0 (at WOFF = 2)
// is aligned.
//
// Occupancy: 72 584 B of dynamic shared memory (two windows, the metric,
// the scratch; PPM's windows 2 x 15 840 with their padding: 74 148) and
// __launch_bounds__(256, 3): 3 blocks per SM, <= 80 registers.  The
// occupancy query runs after the shared-memory attribute
// is set (it reports 0 blocks above 48 KB until then).  The stages run as
// one loop over one copy of the body, and the body reads the thread
// coordinates opaquely (COV_OPAQUE_TID), so the compiler keeps no
// per-thread offsets live across stages and route phases: where it could
// share them, it did, and spilled them.
//
// Bound.  The compact stepper's three stages move 7.56 + 2 x 10.73 us of
// bytes at C384.  This launch must read the carry and b once and write
// the carry once: 25.5 MB -> ~7.6 us at 3.35 TB/s; what it moves between
// phases stays in L2.  The earlier design (one 32 x 16 tile of one face
// per block, 4 blocks per SM, synchronous apron loads, the metric per
// tile and stage) took 260.62 us.
//
// Modes.  The body is a template on h's face-state policy (cov_common.cuh);
// each of the six reconstructions is its own kernel and C entry point
// (cov_step_mega_<mode>_f32; PLR-MC keeps the kernel cov_step_mega_kernel
// and the entry cov_step_mega_f32).  The PLR modes stage PLR-MC's window.
// PPM's h apron is 3 deep: its rows are padded to 40 floats
// (DeepWindow), its 30 rows' bodies take 240 16-byte copies, and its 180
// apron cells with u's 104 are more than one a thread, so some threads
// hold two.  The routes are any halo's (the strips 6 h wide).

#include <cooperative_groups.h>

#include <cstddef>
#include <type_traits>

// The face phases run the faces-in-block body once per stage and work
// item: cov_faces.cuh reads the thread coordinates opaquely (see tid_x).
#define COV_OPAQUE_TID
#include "cov_faces.cuh"

namespace {

using namespace cov;

struct Params {
  const float* y0h;  // (6, n, n) the carry: stage base and stage-1 input
  const float* y0u;  // (2, 6, n, n)
  const float* sn0;  // (6, 6h, n) the carry's strips
  const float* we0;  // (6, n, 6h)
  const float* b;    // (6, m, m) orography, ghosts filled
  const float* xc;   // (m,) tan of the cell-center coordinates
  const float* xf;   // (m,) tan of the left-face coordinates
  const float* fz;   // (6, 3) face-frame z components (c0, cx, cy)
  const int* idx;    // routed rows' flat source rows, _SplitRoute.idx
  const float* tsn;  // (4, 6, 2, h, n) placed rotations, S/N slots
  const float* twe;  // (4, 6, 2, h, n) placed rotations, W/E slots
  const float* met;  // (2, 4, n) stored edge-metric rows M0, M1 per slot
  float* ho;         // (6, n, n) out (and stage-1 result)
  float* uo;         // (2, 6, n, n)
  float* sno;        // (6, 6h, n) out strips (every stage's)
  float* weo;        // (6, n, 6h)
  float* bh;         // (6, n, n) the stage-2 result
  float* bu;         // (2, 6, n, n)
  float* gsn;        // (6, 6h+2, n) routed ghosts + sym rows
  float* gwe;        // (6, n, 6h+2)
  int link_row[12];  // per physical edge: the link's face*4 + slot,
  int back_row[12];  // the back's, and whether the pair is reversed
  int rev[12];
  int sym_src[24];   // per face*4 + slot: edge i as link (i) or back (12+i)
  float AB[3][3];    // per stage: A, B, C of (A y0 + B cur) + C tend
  int n, halo, n_sn, n_we, vec;
  float R2, gravity, two_omega, inv2d, inv_d;
};

// PPM's window (h's apron 3 deep): StageWindowR<Ppm>'s members, h's rows
// padded to 40 floats so that tile column 0 (at h[r][3]) of every row can
// sit on 16 bytes, and a float between h and u_a so that theirs (at
// ua[r][WOFF]) can too.
template <class R>
struct DeepWindow {
  using Recon = R;
  static_assert(R::A == 3, "PPM's apron");
  float h[FTY + 6][FTX + 8];
  float gap[1];
  float ua[FTY + 2][WS];
  float ub[FTY + 2][WS];
  float b[FTY + 2][FTX + 2];
  float tail[3];   // a window a multiple of 16 bytes
};

// The window of h's policy R: StageWindowR for PLR (its 36-float rows
// serve as they are), DeepWindow for PPM.
template <class R>
using MegaWindow =
    std::conditional_t<R::A == 2, StageWindowR<R>, DeepWindow<R>>;

template <class R>
struct Smem {
  float pad[(4 - R::A % 4) % 4];   // puts tile column 0 of each window row
                                   // on 16 bytes
  MegaWindow<R> w[2];   // this face's window and the next one's
  StageMetric mt;
  StageScratch s;
};

// Every window row's tile column 0 on 16 bytes: h's at h[r][A], u_a's and
// u_b's at [r][WOFF], in both windows.
template <class R>
constexpr bool rows_aligned() {
  using W = MegaWindow<R>;
  constexpr size_t w0 = offsetof(Smem<R>, w);
  return (w0 + 4 * R::A) % 16 == 0 && sizeof(W::h[0]) % 16 == 0
         && (WS * 4) % 16 == 0 && sizeof(W) % 16 == 0
         && (w0 + offsetof(W, ua) + 4 * WOFF) % 16 == 0
         && (w0 + offsetof(W, ub) + 4 * WOFF) % 16 == 0;
}
static_assert(rows_aligned<PlrMc>() && rows_aligned<Ppm>(),
              "16-byte window rows at tile column 0");

#ifdef __CUDACC__
// Sixteen bytes global -> shared through L2 only (cp.async.cg); both
// addresses 16-byte aligned.
__device__ __forceinline__ void async_copy16_cg(float* sdst,
                                                const float* gsrc) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(sdst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(gsrc)
               : "memory");
#endif
}
#endif  // __CUDACC__

// The outward sign of slot s (S, N, W, E): -1 at S and W, +1 at N and E.
__device__ __forceinline__ float out_sign(int s) {
  return (s & 1) ? 1.0f : -1.0f;
}

// Row r of [sn ; we^T ; their lane flips] at column k, from the stage's
// strips (written inside the launch from stage 2 on).
__device__ __forceinline__ float strip_row(const Params& p, const float* sn,
                                           const float* we, int r, int k) {
  const int n = p.n, sw = 6 * p.halo, half = 6 * sw;
  if (r >= 2 * half) {        // the lane-flipped copy
    r -= 2 * half;
    k = n - 1 - k;
  }
  if (r < half) return __ldcg(sn + (long)r * n + k);
  r -= half;
  return __ldcg(we + ((long)(r / sw) * n + k) * sw + r % sw);
}

// Routed row `row` (face f, pair p, depth kd) of field fi at column k:
// the gathered row, u rotated by the placed T entries.
__device__ __forceinline__ float routed(const Params& p, const float* sn,
                                        const float* we, const int* idx,
                                        const float* T, int fi, int f, int pr,
                                        int kd, int k) {
  const int n = p.n, hh = p.halo;
  const int per = 6 * 2 * hh;               // rows per field
  const int rf = (f * 2 + pr) * hh + kd;    // row within a field
  if (fi == 0) return strip_row(p, sn, we, idx[rf], k);
  const float c1 = strip_row(p, sn, we, idx[per + rf], k);
  const float c2 = strip_row(p, sn, we, idx[2 * per + rf], k);
  const long t = (long)rf * n + k;
  const long ts = (long)6 * 2 * hh * n;     // one T entry's table
  const int ra = fi == 1 ? 0 : 2;
  return T[ra * ts + t] * c1 + T[(ra + 1) * ts + t] * c2;
}

// The local edge normal of table row `row` (face*4 + slot) at column k:
// M0 ub0 + M1 ub1, ub the mean of the interior edge-adjacent row and the
// rotated edge-adjacent ghost row (_pair_symmetrize's L).
__device__ __forceinline__ float local_normal(const Params& p,
                                              const float* sn,
                                              const float* we, int row,
                                              int k) {
  const int n = p.n, hh = p.halo;
  const int f = row / 4, s = row % 4;
  const int* iu = p.idx + p.n_sn + p.n_we;
  const float iu0 = strip_row(p, sn, we, iu[f * 4 + s], k);
  const float iu1 = strip_row(p, sn, we, iu[(6 + f) * 4 + s], k);
  const int pr = s & 1;
  const int kd = pr == 0 ? hh - 1 : 0;      // placed edge-adjacent depth
  const int* idx = s < 2 ? p.idx : p.idx + p.n_sn;
  const float* T = s < 2 ? p.tsn : p.twe;
  const float ga = routed(p, sn, we, idx, T, 1, f, pr, kd, k);
  const float gb = routed(p, sn, we, idx, T, 2, f, pr, kd, k);
  const float ub0 = 0.5f * (iu0 + ga);
  const float ub1 = 0.5f * (iu1 + gb);
  return p.met[s * n + k] * ub0 + p.met[(4 + s) * n + k] * ub1;
}

// The router phase: every routed ghost and sym element of the stage.
__device__ __forceinline__ void route_phase(const Params& p, const float* sn,
                                            const float* we) {
  const int n = p.n, hh = p.halo, rw = 6 * hh + 2;
  const long n_sn = (long)p.n_sn * n, n_we = (long)p.n_we * n;
  const long total = n_sn + n_we + 24L * n;
  const long stride = (long)gridDim.x * blockDim.x * blockDim.y;
  for (long e = (long)blockIdx.x * blockDim.x * blockDim.y
                + threadIdx.y * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    if (e < n_sn + n_we) {
      const bool is_sn = e < n_sn;
      const long r = is_sn ? e : e - n_sn;
      const int k = r % n, row = r / n;     // row: (fi, f, pair, depth)
      const int kd = row % hh, pr = (row / hh) % 2, f = (row / (2 * hh)) % 6;
      const int fi = row / (12 * hh);
      const float v = routed(p, sn, we, is_sn ? p.idx : p.idx + p.n_sn,
                             is_sn ? p.tsn : p.twe, fi, f, pr, kd, k);
      const int c = fi * 2 * hh + pr * hh + kd;
      if (is_sn) p.gsn[((long)f * rw + c) * n + k] = v;
      else p.gwe[((long)f * n + k) * rw + c] = v;
      continue;
    }
    const long r = e - n_sn - n_we;
    const int k = r % n, row = r / n;       // row: face*4 + slot
    const int src = p.sym_src[row];
    const bool is_link = src < 12;
    const int i = src % 12;
    const int lr = p.link_row[i], br = p.back_row[i];
    const bool rv = p.rev[i] != 0;
    const float sga = out_sign(lr % 4), sgb = out_sign(br % 4);
    const int kk = (is_link || !rv) ? k : n - 1 - k;
    const float la = local_normal(p, sn, we, lr, kk);
    const float lb = local_normal(p, sn, we, br, rv ? n - 1 - kk : kk);
    const float avg = 0.5f * (sga * la - sgb * lb);
    const float v = is_link ? sga * avg : sgb * (-avg);
    const int f = row / 4, s = row % 4;
    if (s < 2) p.gsn[((long)f * rw + 6 * hh + s) * n + k] = v;
    else p.gwe[((long)f * n + k) * rw + 6 * hh + s - 2] = v;
  }
}

// A thread's apron cells of a face window (the columns the 16-byte body
// copies leave out): field fi, window row r, tile column c; fi < 0 for a
// thread without one.  h has 2 A apron columns per row (A its apron: 4
// columns for PLR, 6 for PPM), u_a and u_b 2.  Cell k of the thread is the
// block's cell tid + k * NT: one for PLR (216 cells), two for some
// threads for PPM (284).  A function of the thread alone, recomputed
// where used (no registers held).
struct ApronCell {
  int fi, r, c;
};

// The apron cells a thread may hold (APRON_CELLS) and their values.
template <int A>
constexpr int APRON_CELLS =
    ((FTY + 2 * A) * 2 * A + 2 * (FTY + 2) * 2 + NT - 1) / NT;
template <int A>
struct ApronValues {
  float v[APRON_CELLS<A>];
};

template <int A>
__device__ __forceinline__ ApronCell apron_cell(int k) {
  constexpr int NH = (FTY + 2 * A) * 2 * A, NU = (FTY + 2) * 2;
  const int t = tid_y() * BX + tid_x() + k * NT;
  if (t < NH) {
    const int c = t % (2 * A);
    return {0, t / (2 * A), c < A ? c - A : FTX + c - A};
  }
  const int u = t - NH;
  if (u < 2 * NU) {
    const int v = u % NU;
    return {1 + u / NU, v / 2, (v % 2) ? FTX : -1};
  }
  return {-1, 0, 0};
}

// Copies the body columns (tile columns 0 .. FTX-1) of rows jw ..
// jw+ROWS-1 of field fi of one face into s (row stride S, tile column c
// at s[r * S + OFF + c]): a 16-byte cp.async.cg per 4 cells of an
// interior or S/N ghost row wholly inside the face's columns, else cell by
// cell with __ldcg (0 where edge_src gives none).  No commit.
template <int ROWS, int S = WS, int OFF = WOFF>
__device__ __forceinline__ void stage_body(float* s, const float* q,
                                           const float* gsn,
                                           const float* gwe, int fi, int n,
                                           int hh, int rw, int jw, int i0,
                                           bool vec) {
  constexpr int CH = FTX / 4;   // 16-byte chunks per row
  static_assert(ROWS * CH <= NT, "one chunk per thread");
  const int t = tid_y() * BX + tid_x();
  if (t >= ROWS * CH) return;
  const int r = t / CH, k = t - r * CH;
  const int j = jw + r, i = i0 + 4 * k;
  float* dst = s + r * S + OFF + 4 * k;
  const float* row = nullptr;
  if (j >= 0 && j < n)
    row = q + (long)j * n;
  else if (j < 0 && j >= -hh)
    row = gsn + (long)(fi * 2 * hh + (j + hh)) * n;
  else if (j >= n && j < n + hh)
    row = gsn + (long)(fi * 2 * hh + hh + (j - n)) * n;
  if (vec && row != nullptr && i + 4 <= n) {
    async_copy16_cg(dst, row + i);
    return;
  }
#pragma unroll 1
  for (int c = 0; c < 4; ++c) {
    const float* src = edge_src(q, gsn, gwe, fi, n, hh, rw, j, i + c);
    dst[c] = src != nullptr ? __ldcg(src) : 0.0f;
  }
}

// The value of the thread's apron cell k of face f's window (an __ldcg),
// h's apron A deep; 0 for none.
template <int A>
__device__ __forceinline__ float apron_value(const float* qh,
                                             const float* qa,
                                             const float* qb,
                                             const float* gsn,
                                             const float* gwe, int n, int hh,
                                             int rw, int j0, int i0, int k) {
  const ApronCell a = apron_cell<A>(k);
  if (a.fi < 0) return 0.0f;
  const int jw = a.fi == 0 ? j0 - A : j0 - 1;
  const float* q = a.fi == 0 ? qh : a.fi == 1 ? qa : qb;
  const float* src = edge_src(q, gsn, gwe, a.fi, n, hh, rw, jw + a.r,
                              i0 + a.c);
  return src != nullptr ? __ldcg(src) : 0.0f;
}

// Issues the copies of face f's window of the stage input (h ch, u cu)
// into w (no commit): the bodies and the orography band asynchronously;
// returns the values of the thread's apron cells (__ldcg in flight), for
// put_apron.
template <class R>
__device__ __forceinline__ ApronValues<R::A> stage_window(
    const Params& p, MegaWindow<R>& w, const float* ch, const float* cu,
    int f, int j0, int i0) {
  constexpr int A = R::A;
  constexpr int HS = sizeof(MegaWindow<R>::h[0]) / sizeof(float);
  const int n = p.n, hh = p.halo, m = n + 2 * hh, rw = 6 * hh + 2;
  const long nn = (long)n * n;
  const float* gsn = p.gsn + (long)f * rw * n;
  const float* gwe = p.gwe + (long)f * n * rw;
  const float* qh = ch + f * nn;
  const float* qa = cu + f * nn;
  const float* qb = cu + (6 + f) * nn;
  const bool vec = p.vec != 0;
  stage_body<FTY + 2 * A, HS, A>(&w.h[0][0], qh, gsn, gwe, 0, n, hh, rw,
                                 j0 - A, i0, vec);
  stage_body<FTY + 2>(&w.ua[0][0], qa, gsn, gwe, 1, n, hh, rw, j0 - 1, i0,
                      vec);
  stage_body<FTY + 2>(&w.ub[0][0], qb, gsn, gwe, 2, n, hh, rw, j0 - 1, i0,
                      vec);
  stage_band(w.b, p.b + (long)f * m * m, n, hh, j0, i0);
  ApronValues<A> v;
#pragma unroll
  for (int k = 0; k < APRON_CELLS<A>; ++k)
    v.v[k] = apron_value<A>(qh, qa, qb, gsn, gwe, n, hh, rw, j0, i0, k);
  return v;
}

// Stores the thread's apron values v into window w.
template <class R>
__device__ __forceinline__ void put_apron(MegaWindow<R>& w,
                                          const ApronValues<R::A>& v) {
  constexpr int A = R::A;
#pragma unroll
  for (int k = 0; k < APRON_CELLS<A>; ++k) {
    const ApronCell a = apron_cell<A>(k);
    if (a.fi == 0)
      w.h[a.r][A + a.c] = v.v[k];
    else if (a.fi == 1)
      w.ua[a.r][WOFF + a.c] = v.v[k];
    else if (a.fi == 2)
      w.ub[a.r][WOFF + a.c] = v.v[k];
  }
}

// Stage st on work item t: the three faces from f0 of the tile at (j0,
// i0), from the stage input (h ch, u cu) into oh / ou and the strips, h's
// face states by policy R.  mt_item is the item whose metric terms sm.mt
// holds (-1: none yet).
template <class R>
__device__ __forceinline__ void stage_faces(const Params& p, Smem<R>& sm,
                                            int st,
                                            const float* ch, const float* cu,
                                            float* oh, float* ou, int t,
                                            int f0, int j0, int i0,
                                            int& mt_item) {
  const int n = p.n, hh = p.halo, rw = 6 * hh + 2;
  const long nn = (long)n * n;
  const int lx = tid_x();
  const float A = p.AB[st][0], B = p.AB[st][1], C = p.AB[st][2];
  const StageConsts k{p.R2, p.gravity, p.two_omega, p.inv2d, p.inv_d};
  // The tile holds cells of the boundary strips.
  const bool strips = j0 < hh || i0 < hh || j0 + FTY > n - hh
                      || i0 + FTX > n - hh;

  ApronValues<R::A> apron =
      stage_window<R>(p, sm.w[0], ch, cu, f0, j0, i0);
  async_commit();
  if (mt_item != t) {
    stage_metric(sm.mt, p.xc, p.xf, p.xc, p.xf, p.R2, p.inv_d, n, hh, j0,
                 i0);
    mt_item = t;
  }
  put_apron<R>(sm.w[0], apron);

  for (int q = 0; q < FPB; ++q) {
    const int f = f0 + q, cur = q & 1;
    if (q + 1 < FPB) {
      apron = stage_window<R>(p, sm.w[cur ^ 1], ch, cu, f + 1, j0, i0);
      async_commit();
      async_wait<1>();
    } else {
      async_wait<0>();
    }
    // The combine's y0 at the thread's cells, loaded ahead of the
    // arithmetic.
    float y0[FTY / BY][3] = {};
#pragma unroll
    for (int r = 0; r < FTY / BY; ++r) {
      const int j = j0 + tid_y() + r * BY, i = i0 + lx;
      if (j < n && i < n) {
        const long c = f * nn + (long)j * n + i;
        y0[r][0] = p.y0h[c];
        y0[r][1] = p.y0u[c];
        y0[r][2] = p.y0u[6 * nn + c];
      }
    }
    __syncthreads();   // this face's window (and, first, mt) complete

    const float* gsn = p.gsn + (long)f * rw * n;
    const float* gwe = p.gwe + (long)f * n * rw;
    float* ssn = p.sno + (long)f * 6 * hh * n;
    float* swe = p.weo + (long)f * n * 6 * hh;
    stage_face_tile<Seam::FrameCg>(
        sm.w[cur], sm.mt, sm.s, routed_sym(gsn, gwe, n, hh), p.xc, p.xf,
        p.xc, p.xf, p.fz + 3 * f, k, n, hh, j0, i0,
        [&](int r, int j, int i, float dh, float dua, float dub, float hcv,
            float uav, float ubv) {
          const long c = f * nn + (long)j * n + i;
          const float vals[3] = {(A * y0[r][0] + B * hcv) + C * dh,
                                 (A * y0[r][1] + B * uav) + C * dua,
                                 (A * y0[r][2] + B * ubv) + C * dub};
          oh[c] = vals[0];
          ou[c] = vals[1];
          ou[6 * nn + c] = vals[2];
          if (strips)
            for (int fi = 0; fi < 3; ++fi)
              put_strips(ssn, swe, fi, n, hh, j, i, vals[fi]);
        });
    if (q + 1 < FPB) put_apron<R>(sm.w[cur ^ 1], apron);
    __syncthreads();   // w and the scratch are free for the next face
  }
}

// The face phase of stage st: every work item (tile positions x face
// groups), one pass of the grid when gridDim.x >= the item count.
template <class R>
__device__ __forceinline__ void face_phase(const Params& p, Smem<R>& sm,
                                           int st, int& mt_item) {
  // Stage inputs and outputs: y0 -> out, out -> B, B -> out.
  const float* ch = st == 0 ? p.y0h : st == 1 ? p.ho : p.bh;
  const float* cu = st == 0 ? p.y0u : st == 1 ? p.uo : p.bu;
  float* oh = st == 1 ? p.bh : p.ho;
  float* ou = st == 1 ? p.bu : p.uo;
  const int n = p.n;
  const int nx = (n + FTX - 1) / FTX, ny = (n + FTY - 1) / FTY;
  const int items = nx * ny * (6 / FPB);
  for (int t = blockIdx.x; t < items; t += gridDim.x) {
    const int g = t / (nx * ny), rem = t - g * nx * ny;
    stage_faces<R>(p, sm, st, ch, cu, oh, ou, t, g * FPB, rem / nx * FTY,
                   rem % nx * FTX, mt_item);
  }
}

template <class R>
__device__ __forceinline__ void mega_step(const Params& p) {
  extern __shared__ __align__(16) float smem_raw[];
  Smem<R>& sm = *reinterpret_cast<Smem<R>*>(smem_raw);
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  int mt_item = -1;
  for (int st = 0; st < 3; ++st) {
    route_phase(p, st == 0 ? p.sn0 : p.sno, st == 0 ? p.we0 : p.weo);
    grid.sync();
    face_phase<R>(p, sm, st, mt_item);
    if (st < 2) grid.sync();
  }
}

// One kernel per reconstruction; PLR-MC's keeps its name.
__global__ void __launch_bounds__(NT, 3)
cov_step_mega_kernel(const Params p) {
  mega_step<PlrMc>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_step_mega_kernel_none(const Params p) {
  mega_step<Plr<SlopeNone>>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_step_mega_kernel_minmod(const Params p) {
  mega_step<Plr<SlopeMinmod>>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_step_mega_kernel_mc_sign(const Params p) {
  mega_step<Plr<SlopeMcSign>>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_step_mega_kernel_vanleer(const Params p) {
  mega_step<Plr<SlopeVanleer>>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_step_mega_kernel_ppm(const Params p) {
  mega_step<Ppm>(p);
}

// The launch's parameters, the host tables copied in.
Params make_params(const float* y0h, const float* y0u, const float* sn0,
                   const float* we0, const float* b_ext, const float* xc,
                   const float* xf, const float* fz, const int* idx,
                   const float* tsn, const float* twe, const float* met,
                   float* ho, float* uo, float* sno, float* weo, float* bh,
                   float* bu, float* gsn, float* gwe, const int* tab,
                   const float* ab, int n, int halo, int n_sn, int n_we,
                   int vec, float R2, float gravity, float two_omega,
                   float inv2d, float inv_d) {
  Params p{y0h, y0u, sn0, we0, b_ext, xc, xf, fz, idx, tsn, twe, met, ho,
           uo, sno, weo, bh, bu, gsn, gwe, {}, {}, {}, {}, {}, n, halo,
           n_sn, n_we, vec, R2, gravity, two_omega, inv2d, inv_d};
  for (int i = 0; i < 12; ++i) {
    p.link_row[i] = tab[i];
    p.back_row[i] = tab[12 + i];
    p.rev[i] = tab[24 + i];
  }
  for (int i = 0; i < 24; ++i) p.sym_src[i] = tab[36 + i];
  for (int i = 0; i < 9; ++i) p.AB[i / 3][i % 3] = ab[i];
  return p;
}

// Launches kernel (the instance of policy R) cooperatively on `stream`,
// on every block the card holds at once (at most max_blocks > 0), the
// grid's block count in *blocks.
template <class R>
int launch(void (*kernel)(Params), const Params& p, int max_blocks,
           int* blocks, void* stream) {
  *blocks = 0;
  int rc = dynamic_smem_limit<R>(kernel, sizeof(Smem<R>));
  if (rc != 0) return rc;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                        sizeof(Smem<R>));
  if (err != cudaSuccess) return static_cast<int>(err);
  int nb = per_sm * sms;
  if (max_blocks > 0 && max_blocks < nb) nb = max_blocks;
  *blocks = nb;
  if (nb < 1) return -1;
  void* args[] = {const_cast<Params*>(&p)};
  err = cudaLaunchCooperativeKernel(kernel, dim3(nb), dim3(BX, BY), args,
                                    sizeof(Smem<R>),
                                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

}  // namespace

// Launch one step on `stream`; each returns the cudaError_t of the shared
// memory attribute, the occupancy query or the launch (0 = ok; -1: no
// block fits) and the grid's block count in *blocks: every block the card
// holds at once, at most max_blocks (> 0).  All tensors float32 (idx
// int32), contiguous, in the layouts of Params; vec != 0 when n % 4 == 0
// and the carry, its outputs and gsn / gwe are 16-byte aligned; tab holds
// the host int32 arrays link_row (12), back_row (12), rev (12), sym_src
// (24), and ab the host float32 table AB (3, 3), both copied into the
// launch's parameters.  cov_step_mega_f32 is PLR-MC, cov_step_mega_<mode>_f32
// the other reconstructions (PPM needs halo >= 3).
#define COV_MEGA_ENTRY(NAME, KERNEL, POLICY)                                \
  extern "C" int NAME(                                                      \
      const float* y0h, const float* y0u, const float* sn0,                 \
      const float* we0, const float* b_ext, const float* xc,                \
      const float* xf, const float* fz, const int* idx, const float* tsn,   \
      const float* twe, const float* met, float* ho, float* uo, float* sno, \
      float* weo, float* bh, float* bu, float* gsn, float* gwe,             \
      const int* tab, const float* ab, int n, int halo, int n_sn,           \
      int n_we, int vec, int max_blocks, float R2, float gravity,           \
      float two_omega, float inv2d, float inv_d, int* blocks,               \
      void* stream) {                                                       \
    const Params p = make_params(                                           \
        y0h, y0u, sn0, we0, b_ext, xc, xf, fz, idx, tsn, twe, met, ho, uo,  \
        sno, weo, bh, bu, gsn, gwe, tab, ab, n, halo, n_sn, n_we, vec, R2,  \
        gravity, two_omega, inv2d, inv_d);                                  \
    return launch<POLICY>(KERNEL, p, max_blocks, blocks, stream);           \
  }

COV_MEGA_ENTRY(cov_step_mega_f32, cov_step_mega_kernel, PlrMc)
COV_MEGA_ENTRY(cov_step_mega_none_f32, cov_step_mega_kernel_none,
               Plr<SlopeNone>)
COV_MEGA_ENTRY(cov_step_mega_minmod_f32, cov_step_mega_kernel_minmod,
               Plr<SlopeMinmod>)
COV_MEGA_ENTRY(cov_step_mega_mc_sign_f32, cov_step_mega_kernel_mc_sign,
               Plr<SlopeMcSign>)
COV_MEGA_ENTRY(cov_step_mega_vanleer_f32, cov_step_mega_kernel_vanleer,
               Plr<SlopeVanleer>)
COV_MEGA_ENTRY(cov_step_mega_ppm_f32, cov_step_mega_kernel_ppm, Ppm)
