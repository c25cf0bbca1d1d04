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
// holds (every float lap_metric gives for a tile cell: the x-face pair
// at i and i + 1, the y-face pair at j and j + 1, inv_sqrtg / d), so the
// Laplacian needs no metric and no shared memory of its own.  72 576 B of
// dynamic shared memory and __launch_bounds__(256, 3), as B1: one wave.
//
// Design of B (also B14's body): B2's second half on the same body.  A
// block of 256 threads takes one 32 x 24 tile position and a group of
// three faces, 384 blocks at C384.  It issues the cp.async copies of its
// first face's l1 window (three fields with a 1-deep apron, each cell from
// the interior or the routed l1 strips, the ghost corners as zeros),
// computes the Laplacian's metric terms of the tile once
// (LapMetric<24, 32>, 15 808 B), then per face issues the next face's
// window into the other buffer, loads the face's adv into registers,
// waits for this face's window, builds its ghost corners on edge tiles
// (one thread per corner cell), and computes out = adv - damp lap(l1),
// one tile column per lane, with the strips stored on strip tiles only.
// 38 272 B of dynamic shared memory, __launch_bounds__(256, 3): one wave.
// B14's NoFill stages a 0-deep ring (edge_src with hh = 0) and builds no
// corner; NoLap computes no metric.  Full spills 20 B at the 80-register
// cap; with the field loop unrolled it takes 68 registers and no spill
// but measured 0.16 us slower per launch at C384 (H100 80GB HBM3, 700 W;
// scripts/torch_faces_probe.py --parts b3b7b).

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

// lap_at's metric terms of tile cell (ly, lx), as LapMetric::at gathers
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

struct SmemB {
  float l1[2][3][FTY + 2][WS];   // this face's l1 window and the next one's
  LapMetric<FTY, FTX> mt;
};

// Issues the copies of face f's l1 window (rows j0-1 .. j0+FTY, columns
// i0-1 .. i0+FTX of l1h, l1u_a, l1u_b) into l1 (no commit): each cell from
// the interior or the routed l1 strips; NoFill stages the face's cells
// alone (a 0-deep ring: 0 elsewhere).
template <BMode M>
__device__ __forceinline__ void stage_l1(const ParamsB& p,
                                         float (*l1)[FTY + 2][WS], int f,
                                         int j0, int i0) {
  const int n = p.n, rw = 6 * p.halo + 2;
  const int hh = M == BMode::NoFill ? 0 : p.halo;
  const long nn = (long)n * n;
  const float* gsn = p.gsn + (long)f * rw * n;
  const float* gwe = p.gwe + (long)f * n * rw;
  stage_field<FTY + 2, 1>(&l1[0][0][0], p.l1h + f * nn, gsn, gwe, 0, n, hh,
                          rw, j0 - 1, i0);
  stage_field<FTY + 2, 1>(&l1[1][0][0], p.l1u + f * nn, gsn, gwe, 1, n, hh,
                          rw, j0 - 1, i0);
  stage_field<FTY + 2, 1>(&l1[2][0][0], p.l1u + (6 + f) * nn, gsn, gwe, 2,
                          n, hh, rw, j0 - 1, i0);
}

// The three faces of the block's group on one tile position.
template <BMode M>
__device__ __forceinline__ void stage_faces_b(const ParamsB& p, SmemB& sm,
                                              int f0, int j0, int i0) {
  const int n = p.n, hh = p.halo;
  const long nn = (long)n * n;
  const int lx = threadIdx.x;
  // The window crosses the face edge (ghost corners to build), the tile
  // holds cells of the boundary strips.
  const bool edge = j0 < 1 || i0 < 1 || j0 + FTY + 1 > n || i0 + FTX + 1 > n;
  const bool strips = j0 < hh || i0 < hh || j0 + FTY > n - hh
                      || i0 + FTX > n - hh;

  stage_l1<M>(p, sm.l1[0], f0, j0, i0);
  async_commit();
  if constexpr (M != BMode::NoLap)
    lap_metric(sm.mt, p.xc, p.xf, n, hh, j0, i0, p.R2, p.invd);

  for (int q = 0; q < FPB; ++q) {
    const int f = f0 + q, cur = q & 1;
    if (q + 1 < FPB) {
      stage_l1<M>(p, sm.l1[cur ^ 1], f + 1, j0, i0);
      async_commit();
    }
    // The face's adv at the thread's cells, loaded while the window's
    // copies are in flight.
    float adv[FTY / BY][3] = {};
#pragma unroll
    for (int r = 0; r < FTY / BY; ++r) {
      const int j = j0 + threadIdx.y + r * BY, i = i0 + lx;
      if (j < n && i < n) {
        const long c = f * nn + (long)j * n + i;
        adv[r][0] = p.ha[c];
        adv[r][1] = p.ua[c];
        adv[r][2] = p.ua[6 * nn + c];
      }
    }
    if (q + 1 < FPB)
      async_wait<1>();
    else
      async_wait<0>();
    __syncthreads();   // this face's window (and, first, mt) complete
    float(*l1)[FTY + 2][WS] = sm.l1[cur];
    if (M != BMode::NoFill && edge) {
      for (int fi = 0; fi < 3; ++fi) fill_corners<1>(l1[fi], n, j0, i0);
      __syncthreads();
    }

    // ---- l2 = lap(l1), out = adv - damp l2, stores ----------------------
    float* ssn = p.ssn + (long)f * 6 * hh * n;
    float* swe = p.swe + (long)f * n * 6 * hh;
#pragma unroll
    for (int r = 0; r < FTY / BY; ++r) {
      const int ly = threadIdx.y + r * BY;
      const int j = j0 + ly, i = i0 + lx;
      if (j >= n || i >= n) continue;
      const long c = f * nn + (long)j * n + i;
      float* outs[3] = {p.ho + c, p.uo + c, p.uo + 6 * nn + c};
      for (int fi = 0; fi < 3; ++fi) {
        float l2;
        if constexpr (M == BMode::NoLap)
          l2 = l1[fi][ly + 1][WOFF + lx];
        else
          l2 = lap_at<WS>(&l1[fi][0][0], ly + 1, WOFF + lx, sm.mt.at(ly, lx),
                          p.invd, p.inv2d);
        const float v = adv[r][fi] - p.damp * l2;
        *outs[fi] = v;
        if (strips) put_strips(ssn, swe, fi, n, hh, j, i, v);
      }
    }
    __syncthreads();   // l1[cur] is free for the face after next
  }
}

template <BMode M>
__global__ void __launch_bounds__(NT, 3)
cov_stage_nu4_b_kernel(const ParamsB p) {
  extern __shared__ float smem_raw[];
  SmemB& sm = *reinterpret_cast<SmemB*>(smem_raw);
  stage_faces_b<M>(p, sm, blockIdx.z * FPB, blockIdx.y * FTY,
                   blockIdx.x * FTX);
}

// Launches kernel B in mode M on `stream`; returns cudaGetLastError().
template <BMode M>
int launch_b(const ParamsB& p, void* stream) {
  const dim3 grid((p.n + FTX - 1) / FTX, (p.n + FTY - 1) / FTY, 6 / FPB);
  const dim3 block(BX, BY);
  const size_t smem = sizeof(SmemB);
  void (*kernel)(const ParamsB) = cov_stage_nu4_b_kernel<M>;
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(p);
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
