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
// Design.  One block per 32 x 16 output tile of one face, as the stage
// kernel.  A stages h with a 2-deep apron and u_a, u_b with a 1-deep one,
// as cov_stage.cu does, but through filled(): the Laplacian's cross
// terms read the diagonal apron cells, and at a face corner those are the
// averaged ghost corners (cov_stage.cu stages them as 0; no advective
// output reads them, so the advective outputs are the same).  The metric
// terms of the Laplacian are evaluated per cell (cell_metric) and serve
// all three fields.  B stages l1 with a 1-deep apron and its corners.
// 18.6 KB (A) and 7.3 KB (B) of shared memory per block.
//
// Bound.  A reads h, u, b (stage 1; plus h0, u0 in stages 2-3) and writes
// h_adv, u_adv, l1h, l1u and the l1 strips: ~35.9 MB at C384 (stage 1),
// ~46.5 MB (stages 2-3), 10.7 / 13.9 us at 3.35 TB/s.  B reads adv and l1
// and writes out and its strips: ~32.3 MB, 9.6 us.  Their arithmetic
// (137 + 3 x 22 + 31 = 234 flops per cell for A, 3 x 24 + 31 = 103 for B)
// is 3.1 and 1.4 us at 67 TFLOP/s: both bound by memory.  Simple and
// right first; TMA staging and occupancy are for later.

#include "cov_common.cuh"

namespace {

using namespace cov;

constexpr int AP = 2;      // h apron: PLR reads two cells past a face

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

__global__ void __launch_bounds__(BX * BY, 4)
cov_stage_nu4_a_kernel(const ParamsA p) {
  __shared__ float s_h[TY + 2 * AP][TX + 2 * AP];
  __shared__ float s_ua[TY + 2][TX + 2];
  __shared__ float s_ub[TY + 2][TX + 2];
  __shared__ AdvScratch s_adv;

  const int n = p.n, hh = p.halo, m = n + 2 * hh, rw = 6 * hh + 2;
  const int f = blockIdx.z;
  const int i0 = blockIdx.x * TX, j0 = blockIdx.y * TY;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long nn = (long)n * n;
  const float* hc = p.hc + f * nn;
  const float* ua = p.uc + f * nn;
  const float* ub = p.uc + (6 + f) * nn;
  const float* gsn = p.gsn + (long)f * rw * n;
  const float* gwe = p.gwe + (long)f * n * rw;

  // ---- 1. stage the tile with its aprons, corners averaged ------------
  for (int ly = ty; ly < TY + 2 * AP; ly += BY)
    for (int lx = tx; lx < TX + 2 * AP; lx += BX)
      s_h[ly][lx] = filled(hc, gsn, gwe, 0, n, hh, rw, j0 + ly - AP,
                           i0 + lx - AP);
  for (int ly = ty; ly < TY + 2; ly += BY)
    for (int lx = tx; lx < TX + 2; lx += BX) {
      const int j = j0 + ly - 1, i = i0 + lx - 1;
      s_ua[ly][lx] = filled(ua, gsn, gwe, 1, n, hh, rw, j, i);
      s_ub[ly][lx] = filled(ub, gsn, gwe, 2, n, hh, rw, j, i);
    }
  __syncthreads();

  // ---- 2. advective stage; l1 of the stage input; stores --------------
  float* ssn = p.ssn + (long)f * 6 * hh * n;
  float* swe = p.swe + (long)f * n * 6 * hh;
  const StageConsts k{p.R2, p.gravity, p.two_omega, p.inv2d, p.inv_d};
  advective_tile<true, TX + 2 * AP, TX + 2>(
      &s_h[0][0], &s_ua[0][0], &s_ub[0][0], s_adv,
      routed_sym(gsn, gwe, n, hh), p.b + (long)f * m * m, p.xc, p.xf,
      p.fz + 3 * f, k, n, hh, j0, i0,
      [=](int ly, int lx, int j, int i, float dh, float dua, float dub) {
        const long c = f * nn + (long)j * n + i;
        float y0h = 0.0f, y0a = 0.0f, y0b = 0.0f;
        if (p.with_y0) {
          y0h = p.h0[c];
          y0a = p.u0[c];
          y0b = p.u0[6 * nn + c];
        }
        p.ho[c] = combine(p.with_y0, p.a, p.bcoef, p.g_dt, y0h,
                          s_h[ly + AP][lx + AP], dh);
        p.uo[c] = combine(p.with_y0, p.a, p.bcoef, p.g_dt, y0a,
                          s_ua[ly + 1][lx + 1], dua);
        p.uo[6 * nn + c] = combine(p.with_y0, p.a, p.bcoef, p.g_dt, y0b,
                                   s_ub[ly + 1][lx + 1], dub);
        const CellMetric cm = cell_metric(p.xc, p.xf, hh, j, i, p.R2,
                                          p.inv_d);
        const float l1[3] = {
            lap_at<TX + 2 * AP>(&s_h[0][0], ly + AP, lx + AP, cm, p.inv_d,
                                p.inv2d),
            lap_at<TX + 2>(&s_ua[0][0], ly + 1, lx + 1, cm, p.inv_d,
                           p.inv2d),
            lap_at<TX + 2>(&s_ub[0][0], ly + 1, lx + 1, cm, p.inv_d,
                           p.inv2d)};
        p.l1h[c] = l1[0];
        p.l1u[c] = l1[1];
        p.l1u[6 * nn + c] = l1[2];
        for (int fi = 0; fi < 3; ++fi)
          put_strips(ssn, swe, fi, n, hh, j, i, l1[fi]);
      });
}

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
      for (int fi = 0; fi < 3; ++fi)
        s_l1[fi][ly][lx] = filled(q[fi], gsn, gwe, fi, n, hh, rw, j, i);
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
        const float l2 = lap_at<TX + 2>(&s_l1[fi][0][0], ly + 1, lx + 1, cm,
                                        p.invd, p.inv2d);
        const float v = *adv[fi] - p.damp * l2;
        *outs[fi] = v;
        put_strips(ssn, swe, fi, n, hh, j, i, v);
      }
    }
}

}  // namespace

// Launches kernel A on `stream`; returns cudaGetLastError() (0 = ok).
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
  const dim3 grid((n + TX - 1) / TX, (n + TY - 1) / TY, 6);
  const dim3 block(BX, BY);
  cov_stage_nu4_a_kernel<<<grid, block, 0,
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
  ParamsB p{ha, ua, l1h, l1u, gsn, gwe, xc, xf, ho, uo, ssn, swe,
            n, halo, R2, invd, inv2d, damp};
  const dim3 grid((n + TX - 1) / TX, (n + TY - 1) / TY, 6);
  const dim3 block(BX, BY);
  cov_stage_nu4_b_kernel<<<grid, block, 0,
                           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
