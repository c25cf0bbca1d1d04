// The in-stage del^4 kernel pair of the covariant shallow-water SSPRK3
// step (nu4_mode 'stage'): the Hopper (sm_90a) kernels of
// jaxstream_torch.
//
// Replace the Pallas TPU kernel pair of make_cov_stage_nu4
// (jaxstream/ops/pallas/swe_cov.py:2277, pallas_calls at :2392 (A) and
// :2415 (B)).  The plain PyTorch versions are
// jaxstream_torch.ops.cuda.swe_cov.cov_stage_nu4_a_reference and
// cov_stage_nu4_b_reference; each kernel reproduces its plain version's
// operations in its order (built with -fmad=false).
//
// Kernel B's body also serves the ablated B of the step-budget bisection
// (experiments/nu4_bisect.py::main, variant_b; pallas_call at :190),
// launched through cov_stage_nu4_b_ablated_f32 (BMode below; plain
// versions in jaxstream_torch.experiments.nu4_bisect).
//
// One RK stage is A, a route of A's l1 strips, then B:
//   A   psi = h, u_a, u_b of the stage input yc, extended by the routed
//       ghosts with averaged corners; the advective stage exactly as
//       cov_stage.cu computes it (a*y0 + b*yc + b*dt*L(yc), L the
//       covariant RHS with the prescaled sym rows), written as h_adv,
//       u_adv; and l1 = lap(psi) on the interior (ring 0) with the
//       boundary strips of l1.
//   B   l1 extended by its routed ghosts with averaged corners; l2 =
//       lap(l1) on the interior; out = adv - damp l2 with damp =
//       f32(b dt nu4), and its boundary strips.
//
// Bound.  A reads h, u, b (stage 1; plus h0, u0 in stages 2-3) and writes
// h_adv, u_adv, l1h, l1u and the l1 strips: ~35.9 MB at C384 (stage 1),
// ~46.5 MB (stages 2-3), 10.7 / 13.9 us at 3.35 TB/s.  B reads adv and l1
// and writes out and its strips: ~32.3 MB, 9.6 us.  Their arithmetic
// (137 + 3 x 22 + 31 = 234 flops per cell for A, 3 x 24 + 31 = 103 for B)
// is 3.1 and 1.4 us at 67 TFLOP/s: both bound by memory.  The bytes of a
// launch fit the 50 MB L2, so what a tile-per-block kernel spends is
// latency and instructions: scalar, branchy staging that nothing
// overlaps, and the closed-form metric rebuilt for each face.
//
// Design of A.  B1's faces-in-block body (cov_faces.cuh): a block of 256
// threads takes one 32 x 24 tile position and a group of three faces, a
// grid of (ceil(n/32), ceil(n/24), 2), 384 blocks at C384.  It issues the
// asynchronous copies (cp.async) of its first face's window (h with a
// 2-deep apron, u_a, u_b with a 1-deep one, b on the Bernoulli band; each
// cell from the interior or the routed strips, the ghost corners as
// zeros), computes the tile's metric terms once (StageMetric), then per
// face issues the next face's window into the other buffer, loads the
// combine's y0, waits for this face's window, and on tiles at a face edge
// builds its ghost corners in shared memory from the staged edge ghosts
// (_fill(corners=True)'s average, one thread per corner cell: a loop over
// the window's cells, as cov_nu4_filter.cu's, cost ~6.5 us per launch at
// C384 on the H100; stage_face_tile reads no corner cell, so the
// advective outputs are B1's).  stage_face_tile<Seam::Prescaled>
// writes h_adv, u_adv; l1 = lap(psi) of the three fields follows on the
// tile from the same window, with the metric terms StageMetric already
// holds (every float cell_metric gives for a tile cell: the x-face pair
// at i and i + 1, the y-face pair at j and j + 1, inv_sqrtg / d), so the
// Laplacian needs no metric and no shared memory of its own.  72 576 B of
// dynamic shared memory and __launch_bounds__(256, 3), as B1: one wave.
//
// Design of B (also B14's body).  One block per 32 x 16 output tile of
// one face.  B stages l1 with a 1-deep apron through filled(), its corners
// averaged, and evaluates the Laplacian's metric terms per cell
// (cell_metric).  7.3 KB of shared memory per block.

#include "cov_faces.cuh"

namespace {

using namespace cov;

struct ParamsA {
  const float* h0;   // (6, n, n) stage base, read only if with_y0
  const float* u0;   // (2, 6, n, n)
  const float* hc;   // (6, n, n) stage input
  const float* uc;   // (2, 6, n, n)
  const float* gsn;  // (6, 6h+2, n) routed S/N ghosts + sym rows
  const float* gwe;  // (6, n, 6h+2) routed W/E ghosts + sym columns
  const float* b;    // (6, m, m) orography, ghosts filled
  const float* xc;   // (m,) tan of the cell-center coordinates
  const float* xf;   // (m,) tan of the left-face coordinates
  const float* fz;   // (6, 3) face-frame z components (c0, cx, cy)
  float* ho;         // (6, n, n) h_adv
  float* uo;         // (2, 6, n, n) u_adv
  float* l1h;        // (6, n, n) lap(h)
  float* l1u;        // (2, 6, n, n) lap(u_a), lap(u_b)
  float* ssn;        // (6, 6h, n) strips of l1
  float* swe;        // (6, n, 6h)
  int n, halo, with_y0;
  // inv2d = f32(1/(2d)) serves the stage and the Laplacian alike: it is
  // the correctly rounded 1/(2d), as f32(0.5/d) is.
  float R2, gravity, two_omega, inv2d, inv_d, a, bcoef, g_dt;
};

struct ParamsB {
  const float* ha;   // (6, n, n) h_adv
  const float* ua;   // (2, 6, n, n) u_adv
  const float* l1h;  // (6, n, n)
  const float* l1u;  // (2, 6, n, n)
  const float* gsn;  // (6, 6h+2, n) routed l1 ghosts (+ sym rows, unread)
  const float* gwe;  // (6, n, 6h+2)
  const float* xc;
  const float* xf;
  float* ho;         // (6, n, n)
  float* uo;         // (2, 6, n, n)
  float* ssn;        // (6, 6h, n)
  float* swe;        // (6, n, 6h)
  int n, halo;
  float R2, invd, inv2d, damp;
};

struct SmemA {
  StageWindow w[2];   // this face's window and the next one's
  StageMetric mt;
  StageScratch s;
};

// Issues the copies of face f's window into w (no commit).
__device__ __forceinline__ void stage_window_a(const ParamsA& p,
                                               StageWindow& w, int f,
                                               int j0, int i0) {
  const int n = p.n, hh = p.halo, m = n + 2 * hh, rw = 6 * hh + 2;
  const long nn = (long)n * n;
  const float* gsn = p.gsn + (long)f * rw * n;
  const float* gwe = p.gwe + (long)f * n * rw;
  stage_field<FTY + 4, 2>(&w.h[0][0], p.hc + f * nn, gsn, gwe, 0, n, hh, rw,
                          j0 - 2, i0);
  stage_field<FTY + 2, 1>(&w.ua[0][0], p.uc + f * nn, gsn, gwe, 1, n, hh,
                          rw, j0 - 1, i0);
  stage_field<FTY + 2, 1>(&w.ub[0][0], p.uc + (6 + f) * nn, gsn, gwe, 2, n,
                          hh, rw, j0 - 1, i0);
  stage_band(w.b, p.b + (long)f * m * m, n, hh, j0, i0);
}

// The h x h ghost corners of one staged field s (rows j0-A .. j0+FTY+A-1,
// columns i0-A .. i0+FTX+A-1; row stride WS): _fill(corners=True)'s
// average of the S/N ghost at the nearest interior column and the W/E
// ghost at the nearest interior row, both in the window already.  The
// window holds at most A x A cells of each of the face's four corners:
// thread t < 4 A^2 takes one of them.
template <int A>
__device__ __forceinline__ void fill_corners(float (*s)[WS], int n, int j0,
                                             int i0) {
  const int t = threadIdx.y * BX + threadIdx.x;
  if (t >= 4 * A * A) return;
  const int corner = t / (A * A), e = t - corner * (A * A);
  const int dj = e / A, di = e - dj * A;
  const int j = corner & 1 ? n + dj : -1 - dj;   // N : S
  const int i = corner & 2 ? n + di : -1 - di;   // E : W
  const int r = j - (j0 - A), c = i - i0;        // window row, tile column
  if (r < 0 || r >= FTY + 2 * A || c < -A || c >= FTX + A) return;
  const int ce = (i < 0 ? 0 : n - 1) - i0;       // nearest interior column
  const int re = (j < 0 ? 0 : n - 1) - (j0 - A); // and row
  s[r][WOFF + c] = 0.5f * (s[r][WOFF + ce] + s[re][WOFF + c]);
}

// lap_at's metric terms of tile cell (ly, lx), as cell_metric computes
// them: the x-face pairs at its left and right faces, the y-face pairs at
// its lower and upper faces, inv_sqrtg / d at its centre.
__device__ __forceinline__ CellMetric tile_cell_metric(const StageMetric& mt,
                                                       int ly, int lx) {
  return CellMetric{mt.xa[ly][lx],     mt.xb[ly][lx], mt.xa[ly][lx + 1],
                    mt.xb[ly][lx + 1], mt.yb[ly][lx], mt.ya[ly][lx],
                    mt.yb[ly + 1][lx], mt.ya[ly + 1][lx], mt.isgd[ly][lx]};
}

// l1 = lap(psi) of the three fields at tile cell (ly, lx), (j, i), from
// the window w, stored with its strips.
__device__ __forceinline__ void put_l1(const ParamsA& p, const StageWindow& w,
                                       const StageMetric& mt, int f, int ly,
                                       int lx, int j, int i, bool strips) {
  const int n = p.n, hh = p.halo;
  const long nn = (long)n * n;
  const CellMetric cm = tile_cell_metric(mt, ly, lx);
  const float l1[3] = {
      lap_at<WS>(&w.h[0][0], ly + 2, WOFF + lx, cm, p.inv_d, p.inv2d),
      lap_at<WS>(&w.ua[0][0], ly + 1, WOFF + lx, cm, p.inv_d, p.inv2d),
      lap_at<WS>(&w.ub[0][0], ly + 1, WOFF + lx, cm, p.inv_d, p.inv2d)};
  const long c = f * nn + (long)j * n + i;
  p.l1h[c] = l1[0];
  p.l1u[c] = l1[1];
  p.l1u[6 * nn + c] = l1[2];
  if (strips) {
    float* ssn = p.ssn + (long)f * 6 * hh * n;
    float* swe = p.swe + (long)f * n * 6 * hh;
    for (int fi = 0; fi < 3; ++fi)
      put_strips(ssn, swe, fi, n, hh, j, i, l1[fi]);
  }
}

// The three faces of the block's group on one tile position.
__device__ __forceinline__ void stage_faces_a(const ParamsA& p, SmemA& sm,
                                              int f0, int j0, int i0) {
  const int n = p.n, hh = p.halo, rw = 6 * hh + 2;
  const long nn = (long)n * n;
  const int lx = threadIdx.x;
  const StageConsts k{p.R2, p.gravity, p.two_omega, p.inv2d, p.inv_d};
  // The window crosses the face edge (ghost corners to build), the tile
  // holds cells of the boundary strips.
  const bool edge = j0 < 2 || i0 < 2 || j0 + FTY + 2 > n || i0 + FTX + 2 > n;
  const bool strips = j0 < hh || i0 < hh || j0 + FTY > n - hh
                      || i0 + FTX > n - hh;

  stage_window_a(p, sm.w[0], f0, j0, i0);
  async_commit();
  stage_metric(sm.mt, p.xc, p.xf, p.xc, p.xf, p.R2, p.inv_d, n, hh, j0, i0);

  for (int q = 0; q < FPB; ++q) {
    const int f = f0 + q, cur = q & 1;
    if (q + 1 < FPB) {
      stage_window_a(p, sm.w[cur ^ 1], f + 1, j0, i0);
      async_commit();
      async_wait<1>();
    } else {
      async_wait<0>();
    }
    // The combine's y0 at the thread's cells, loaded ahead of the
    // arithmetic.
    float y0[FTY / BY][3] = {};
    if (p.with_y0) {
#pragma unroll
      for (int r = 0; r < FTY / BY; ++r) {
        const int j = j0 + threadIdx.y + r * BY, i = i0 + lx;
        if (j < n && i < n) {
          const long c = f * nn + (long)j * n + i;
          y0[r][0] = p.h0[c];
          y0[r][1] = p.u0[c];
          y0[r][2] = p.u0[6 * nn + c];
        }
      }
    }
    __syncthreads();   // this face's window (and, first, mt) complete

    StageWindow& w = sm.w[cur];
    // The corners: stage_face_tile reads none of them, and its barrier
    // publishes them before the Laplacian reads them.
    if (edge) {
      fill_corners<2>(w.h, n, j0, i0);
      fill_corners<1>(w.ua, n, j0, i0);
      fill_corners<1>(w.ub, n, j0, i0);
    }
    const float* gsn = p.gsn + (long)f * rw * n;
    const float* gwe = p.gwe + (long)f * n * rw;
    stage_face_tile<Seam::Prescaled>(
        w, sm.mt, sm.s, routed_sym(gsn, gwe, n, hh), p.xc, p.xf, p.xc,
        p.xf, p.fz + 3 * f, k, n, hh, j0, i0,
        [&](int r, int j, int i, float dh, float dua, float dub, float hcv,
            float uav, float ubv) {
          const long c = f * nn + (long)j * n + i;
          p.ho[c] = combine(p.with_y0, p.a, p.bcoef, p.g_dt, y0[r][0], hcv,
                            dh);
          p.uo[c] = combine(p.with_y0, p.a, p.bcoef, p.g_dt, y0[r][1], uav,
                            dua);
          p.uo[6 * nn + c] = combine(p.with_y0, p.a, p.bcoef, p.g_dt,
                                     y0[r][2], ubv, dub);
        });
    // l1 in a pass of its own, which keeps the Laplacian's registers apart
    // from the tendency's (inside the epilogue it measured the same or
    // slower, scripts/torch_faces_probe.py).
#pragma unroll
    for (int r = 0; r < FTY / BY; ++r) {
      const int ly = threadIdx.y + r * BY;
      const int j = j0 + ly, i = i0 + lx;
      if (j < n && i < n) put_l1(p, w, sm.mt, f, ly, lx, j, i, strips);
    }
    __syncthreads();   // w and the scratch are free for the next face
  }
}

__global__ void __launch_bounds__(NT, 3)
cov_stage_nu4_a_kernel(const ParamsA p) {
  extern __shared__ float smem_raw[];
  SmemA& sm = *reinterpret_cast<SmemA*>(smem_raw);
  stage_faces_a(p, sm, blockIdx.z * FPB, blockIdx.y * FTY, blockIdx.x * FTX);
}

// What kernel B computes: Full is the in-stage pair's B; NoFill and NoLap
// are the ablations of the JAX package's step-budget bisection
// (experiments/nu4_bisect.py::main, variant_b), which time B without its
// ghost fill and without its Laplacian.
//   NoFill  the 1-deep apron holds the face interior where the cell is on
//           the face and 0 outside it: no routed ghost, no corner
//           average (the JAX variant leaves those cells as whatever its
//           scratch held; 0 makes the output defined).
//   NoLap   the apron filled as in Full; out = adv - damp l1 at the
//           cell itself.
// The three share one body; each emits its output's strips as Full does.
enum class BMode : int { Full = 0, NoFill = 1, NoLap = 2 };

template <BMode M>
__global__ void __launch_bounds__(BX * BY, 4)
cov_stage_nu4_b_kernel(const ParamsB p) {
  __shared__ float s_l1[3][TY + 2][TX + 2];

  const int n = p.n, hh = p.halo, rw = 6 * hh + 2;
  const int f = blockIdx.z;
  const int i0 = blockIdx.x * TX, j0 = blockIdx.y * TY;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long nn = (long)n * n;
  const float* q[3] = {p.l1h + f * nn, p.l1u + f * nn,
                       p.l1u + (6 + f) * nn};
  const float* gsn = p.gsn + (long)f * rw * n;
  const float* gwe = p.gwe + (long)f * n * rw;

  // ---- 1. l1 with a 1-deep apron, its ghost corners averaged ----------
  for (int ly = ty; ly < TY + 2; ly += BY)
    for (int lx = tx; lx < TX + 2; lx += BX) {
      const int j = j0 + ly - 1, i = i0 + lx - 1;
      for (int fi = 0; fi < 3; ++fi) {
        if constexpr (M == BMode::NoFill)
          s_l1[fi][ly][lx] = (j >= 0 && j < n && i >= 0 && i < n)
                                 ? q[fi][j * n + i] : 0.0f;
        else
          s_l1[fi][ly][lx] = filled(q[fi], gsn, gwe, fi, n, hh, rw, j, i);
      }
    }
  __syncthreads();

  // ---- 2. l2 = lap(l1), out = adv - damp l2, stores --------------------
  float* ssn = p.ssn + (long)f * 6 * hh * n;
  float* swe = p.swe + (long)f * n * 6 * hh;
  for (int ly = ty; ly < TY; ly += BY)
    for (int lx = tx; lx < TX; lx += BX) {
      const int j = j0 + ly, i = i0 + lx;
      if (j >= n || i >= n) continue;
      const CellMetric cm = cell_metric(p.xc, p.xf, hh, j, i, p.R2, p.invd);
      const long c = f * nn + (long)j * n + i;
      const float* adv[3] = {p.ha + c, p.ua + c, p.ua + 6 * nn + c};
      float* outs[3] = {p.ho + c, p.uo + c, p.uo + 6 * nn + c};
      for (int fi = 0; fi < 3; ++fi) {
        float l2;
        if constexpr (M == BMode::NoLap)
          l2 = s_l1[fi][ly + 1][lx + 1];
        else
          l2 = lap_at<TX + 2>(&s_l1[fi][0][0], ly + 1, lx + 1, cm, p.invd,
                              p.inv2d);
        const float v = *adv[fi] - p.damp * l2;
        *outs[fi] = v;
        put_strips(ssn, swe, fi, n, hh, j, i, v);
      }
    }
}

// Launches kernel B in mode M on `stream`; returns cudaGetLastError().
template <BMode M>
int launch_b(const ParamsB& p, void* stream) {
  const dim3 grid((p.n + TX - 1) / TX, (p.n + TY - 1) / TY, 6);
  const dim3 block(BX, BY);
  void (*kernel)(const ParamsB) = cov_stage_nu4_b_kernel<M>;
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches kernel A on `stream`; returns the cudaError_t of the shared
// memory attribute or of the launch (0 = ok).
// with_y0 == 0: yc + g_dt*L (stage 1); with_y0 != 0: (a*y0 + b*yc) +
// g_dt*L (h0/u0 read only then).  All tensors float32, contiguous, in the
// layouts of ParamsA.
extern "C" int cov_stage_nu4_a_f32(
    const float* h0, const float* u0, const float* hc, const float* uc,
    const float* gsn, const float* gwe, const float* b_ext,
    const float* xc, const float* xf, const float* fz,
    float* ho, float* uo, float* l1h, float* l1u, float* ssn, float* swe,
    int n, int halo, int with_y0,
    float R2, float gravity, float two_omega, float inv2d, float inv_d,
    float a, float b, float g_dt, void* stream) {
  ParamsA p{h0, u0, hc, uc, gsn, gwe, b_ext, xc, xf, fz, ho, uo, l1h, l1u,
            ssn, swe, n, halo, with_y0, R2, gravity, two_omega, inv2d,
            inv_d, a, b, g_dt};
  const int rc = dynamic_smem_limit(cov_stage_nu4_a_kernel, sizeof(SmemA));
  if (rc != 0) return rc;
  const dim3 grid((n + FTX - 1) / FTX, (n + FTY - 1) / FTY, 6 / FPB);
  const dim3 block(BX, BY);
  const size_t smem = sizeof(SmemA);
  cov_stage_nu4_a_kernel<<<grid, block, smem,
                           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Launches kernel B on `stream`; returns cudaGetLastError() (0 = ok).
// All tensors float32, contiguous, in the layouts of ParamsB.
extern "C" int cov_stage_nu4_b_f32(
    const float* ha, const float* ua, const float* l1h, const float* l1u,
    const float* gsn, const float* gwe, const float* xc, const float* xf,
    float* ho, float* uo, float* ssn, float* swe, int n, int halo,
    float R2, float invd, float inv2d, float damp, void* stream) {
  const ParamsB p{ha, ua, l1h, l1u, gsn, gwe, xc, xf, ho, uo, ssn, swe,
                  n, halo, R2, invd, inv2d, damp};
  return launch_b<BMode::Full>(p, stream);
}

// Launches kernel B in mode 0 (Full), 1 (NoFill) or 2 (NoLap) on
// `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue for
// another mode.  Arguments as cov_stage_nu4_b_f32's; NoFill reads no
// routed ghosts.
extern "C" int cov_stage_nu4_b_ablated_f32(
    const float* ha, const float* ua, const float* l1h, const float* l1u,
    const float* gsn, const float* gwe, const float* xc, const float* xf,
    float* ho, float* uo, float* ssn, float* swe, int n, int halo,
    int mode, float R2, float invd, float inv2d, float damp, void* stream) {
  const ParamsB p{ha, ua, l1h, l1u, gsn, gwe, xc, xf, ho, uo, ssn, swe,
                  n, halo, R2, invd, inv2d, damp};
  switch (mode) {
    case static_cast<int>(BMode::Full):
      return launch_b<BMode::Full>(p, stream);
    case static_cast<int>(BMode::NoFill):
      return launch_b<BMode::NoFill>(p, stream);
    case static_cast<int>(BMode::NoLap):
      return launch_b<BMode::NoLap>(p, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
