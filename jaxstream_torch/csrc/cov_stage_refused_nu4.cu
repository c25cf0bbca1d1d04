// Stage 1 of the covariant shallow-water SSPRK3 step with the del^4
// filter fused in front of it (nu4_mode 'refused'): the Hopper (sm_90a)
// kernel of jaxstream_torch.
//
// Replaces the Pallas TPU kernel make_cov_stage_refused_nu4
// (jaxstream/ops/pallas/swe_cov.py:2748, pallas_call at :2843).  The plain
// PyTorch version of the same function is
// jaxstream_torch.ops.cuda.swe_cov.cov_stage_refused_nu4_reference; the
// kernel reproduces its operations in its order (built with -fmad=false).
//
// What it computes, per face f, from the step's carry (h, u) and its
// routed ghosts gsn (6, 6h+2, n) / gwe (6, n, 6h+2):
//   psi    h, u_a, u_b extended by the routed ghosts, the h x h ghost
//          corners averaged (_fill(corners=True));
//   fv     q - damp lap(lap q) on the interior, damp = f32(dt nu4), the
//          first Laplacian on ring 1 (cov_nu4_filter.cu's arithmetic);
//   E      fv on the interior, the UNFILTERED routed ghosts past the face
//          edge (the re-fused design's O(damp) seam inconsistency: the
//          filtered ghosts would need deeper strips);
//   L(E)   the covariant right-hand side on E (rhs_core_cov, the
//          prescaled sym rows imposed on the boundary faces);
//   out    h1 = fv + f32(dt) L (stage 1: a = 0, b = 1), u1 likewise, the
//          filtered base h0f = fv, u0f = fv_u for stages 2 and 3, and the
//          boundary strips of (h1, u1).
//
// Design.  One block per 32 x 16 output tile of one face, as the stage
// and filter kernels.  The stage's stencils read E up to 2 cells past the
// tile (PLR for h, 1 for u), so a block filters on the tile plus a 2-deep
// apron: l2 there needs l1 on tile + 3, which needs psi on tile + 4, all
// clipped to the face's halo-deep frame (cov_common.cuh's nu4_window with
// apron 2).  Neighbouring blocks recompute the shared apron cells in the
// same operation order, so no block waits for another and the result is
// bitwise reproducible.  Shared memory: psi (3 x 24 x 40) and l1
// (3 x 22 x 38) for the filter phases, which the advective phase's
// scratch reuses once E is built (a union); E (3 x 20 x 36); the metric
// terms of l1's window.  47.4 KB per block, under the 48 KB static limit,
// so 4 blocks of 256 threads fit on an SM.
//
// Bound.  It reads h, u, b (14.2 MB at C384) and the ghost blocks
// (0.26 MB) and writes h1, u1, h0f, u0f (21.2 MB) and the strips
// (0.22 MB): ~35.9 MB, 10.7 us at 3.35 TB/s.  Its arithmetic, the filter's
// 169 and the stage's 137 flops per cell on the tile (the apron's
// recomputation left out), is ~0.27 GFLOP, 4.0 us at 67 TFLOP/s: bound by
// memory.  Simple and right first; TMA staging and occupancy are for
// later.

#include "cov_common.cuh"

namespace {

using namespace cov;

constexpr int AE = 2;              // E apron: PLR reads two cells past a face
constexpr int EX = TX + 2 * AE;    // E window: the tile plus the apron
constexpr int EY = TY + 2 * AE;

struct Params {
  const float* hc;   // (6, n, n) the step's carry
  const float* uc;   // (2, 6, n, n)
  const float* gsn;  // (6, 6h+2, n) routed S/N ghosts + sym rows
  const float* gwe;  // (6, n, 6h+2) routed W/E ghosts + sym columns
  const float* b;    // (6, m, m) orography, ghosts filled
  const float* xc;   // (m,) tan of the cell-center coordinates
  const float* xf;   // (m,) tan of the left-face coordinates
  const float* fz;   // (6, 3) face-frame z components (c0, cx, cy)
  float* ho;         // (6, n, n) h1
  float* uo;         // (2, 6, n, n) u1
  float* h0f;        // (6, n, n) filtered h
  float* u0f;        // (2, 6, n, n) filtered u
  float* ssn;        // (6, 6h, n) strips of (h1, u1)
  float* swe;        // (6, n, 6h)
  int n, halo;
  // inv2d = f32(1/(2d)) serves the stage and the Laplacians alike: it is
  // the correctly rounded 1/(2d), as f32(0.5/d) is.
  float R2, gravity, two_omega, inv2d, inv_d, g_dt, damp;
};

__global__ void __launch_bounds__(BX * BY, 4)
cov_stage_refused_nu4_kernel(const Params p) {
  // The filter's windows are dead once E is built; the advective
  // scratch takes their place.
  __shared__ union Scratch {
    Nu4Window<AE> w;
    AdvScratch adv;
  } s;
  __shared__ Nu4Metric<AE> s_mt;
  __shared__ float s_e[3][EY][EX];

  const int n = p.n, hh = p.halo, m = n + 2 * hh, rw = 6 * hh + 2;
  const int f = blockIdx.z;
  const int i0 = blockIdx.x * TX, j0 = blockIdx.y * TY;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long nn = (long)n * n;
  const float* q[3] = {p.hc + f * nn, p.uc + f * nn, p.uc + (6 + f) * nn};
  const float* gsn = p.gsn + (long)f * rw * n;
  const float* gwe = p.gwe + (long)f * n * rw;

  // ---- 1. psi on tile + 4, l1 on tile + 3 ------------------------------
  nu4_window<AE>(s.w, s_mt, q, gsn, gwe, p.xc, p.xf, n, hh, j0, i0, p.R2,
                 p.inv_d, p.inv2d);

  // ---- 2. E on tile + 2: filtered interior, unfiltered ghosts ----------
  for (int ey = ty; ey < EY; ey += BY)
    for (int ex = tx; ex < EX; ex += BX) {
      const int j = j0 - AE + ey, i = i0 - AE + ex;
      const bool inside = j >= 0 && j < n && i >= 0 && i < n;
      const CellMetric cm = s_mt.at(ey + 1, ex + 1);
      for (int fi = 0; fi < 3; ++fi)
        s_e[fi][ey][ex] =
            inside ? nu4_filtered<AE>(s.w, fi, ey, ex, cm, p.inv_d, p.inv2d,
                                      p.damp)
                   : s.w.psi[fi][ey + 2][ex + 2];
    }
  __syncthreads();

  // ---- 3. the stage on E; h1, u1, h0f, u0f and strips ------------------
  float* ssn = p.ssn + (long)f * 6 * hh * n;
  float* swe = p.swe + (long)f * n * 6 * hh;
  const StageConsts k{p.R2, p.gravity, p.two_omega, p.inv2d, p.inv_d};
  advective_tile<true, EX, EX>(
      &s_e[0][0][0], &s_e[1][1][1], &s_e[2][1][1], s.adv,
      routed_sym(gsn, gwe, n, hh), p.b + (long)f * m * m, p.xc, p.xf,
      p.fz + 3 * f, k, n, hh, j0, i0,
      [=](int ly, int lx, int j, int i, float dh, float dua, float dub) {
        const long c = f * nn + (long)j * n + i;
        const float fv[3] = {s_e[0][ly + AE][lx + AE],
                             s_e[1][ly + AE][lx + AE],
                             s_e[2][ly + AE][lx + AE]};
        const float vals[3] = {fv[0] + p.g_dt * dh, fv[1] + p.g_dt * dua,
                               fv[2] + p.g_dt * dub};
        p.ho[c] = vals[0];
        p.uo[c] = vals[1];
        p.uo[6 * nn + c] = vals[2];
        p.h0f[c] = fv[0];
        p.u0f[c] = fv[1];
        p.u0f[6 * nn + c] = fv[2];
        for (int fi = 0; fi < 3; ++fi)
          put_strips(ssn, swe, fi, n, hh, j, i, vals[fi]);
      });
}

}  // namespace

// Launches the re-fused stage 1 on `stream`; returns cudaGetLastError()
// (0 = ok).  All tensors float32, contiguous, in the layouts of Params.
extern "C" int cov_stage_refused_nu4_f32(
    const float* hc, const float* uc, const float* gsn, const float* gwe,
    const float* b_ext, const float* xc, const float* xf, const float* fz,
    float* ho, float* uo, float* h0f, float* u0f, float* ssn, float* swe,
    int n, int halo, float R2, float gravity, float two_omega, float inv2d,
    float inv_d, float g_dt, float damp, void* stream) {
  Params p{hc, uc, gsn, gwe, b_ext, xc, xf, fz, ho, uo, h0f, u0f, ssn, swe,
           n, halo, R2, gravity, two_omega, inv2d, inv_d, g_dt, damp};
  const dim3 grid((n + TX - 1) / TX, (n + TY - 1) / TY, 6);
  const dim3 block(BX, BY);
  cov_stage_refused_nu4_kernel<<<grid, block, 0,
                                 static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
