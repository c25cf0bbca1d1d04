// One SSPRK3 stage of the covariant shallow-water equations on the
// cubed sphere, over interior-only state: the Hopper (sm_90a) kernel of
// jaxstream_torch.
//
// Replaces the Pallas TPU kernel make_cov_stage_compact
// (jaxstream/ops/pallas/swe_cov.py:1689, pallas_call at :1989) with its
// in-kernel ghost fill (_make_fill), the covariant right-hand side
// (rhs_core_cov, with sym_prescaled=True) and the RK combine + boundary
// strip emit.  The plain PyTorch version of the same function is
// jaxstream_torch.ops.cuda.swe_cov.cov_stage_compact_reference; the
// kernel reproduces its operations in its order (built with -fmad=false,
// so every multiply and add rounds separately, as PyTorch's do).
//
// What it computes, per face f and interior cell (j, i):
//   ghosts   h, u_a, u_b one/two cells past the face edge come from the
//            routed strips gsn (6, 6h+2, n) / gwe (6, n, 6h+2), field fi
//            at rows/columns fi*2h .. fi*2h+2h (S|N, W|E); the last two
//            rows/columns are the sqrtg-prescaled symmetrized edge
//            normals, imposed as they are on the boundary fluxes.
//   dh       -(1/(sqrtg d)) [flux differences], upwind PLR-MC h times the
//            sqrtg-folded contravariant face velocity.
//   du       vector-invariant momentum: (zeta + f) sqrtg u^perp minus the
//            centered gradient of g (h + b) + K; metrics in closed form
//            from X = tan(alpha), Y = tan(beta) (no metric arrays read).
//   y_new    stage 1: yc + g*dt*L; stages 2-3: (a*y0 + b*yc) + b*dt*L;
//            written with the new boundary strips (6, 6h, n) / (6, n, 6h).
//
// Design.  The TPU kernel holds a whole (m, m) face of three fields in
// VMEM (602 KB per field at C384); a Hopper block has 227 KB of shared
// memory, so each block takes one 32 x 16 tile of one face: a grid of
// (ceil(n/32), ceil(n/16), 6) independent blocks, no atomics, bitwise
// reproducible.  A block stages its tile of h with a 2-deep apron and of
// u_a, u_b with a 1-deep apron in shared memory, reading each apron cell
// from the interior arrays or, past the face edge, from the routed ghost
// strips.  The stencils are dimension-split, so the apron needs edge
// ghosts only: no kept output reads an h x h ghost corner, and those
// cells are staged as zeros.  Face fluxes and the Bernoulli band are
// computed once per tile into shared memory (19 KB in all) and then
// differenced (cov_common.cuh's advective_tile, which the del^4 stage
// kernels share).
//
// Bound.  With ~137 flops per cell per stage (jaxstream/utils/
// profiling.py:136) the stage does 6 n^2 * 137 flops; it moves 7 field
// passes of 6 n^2 float32 (stage 1: h, u_a, u_b in and out plus b) or 10
// (stages 2-3: plus y0), and the strips.  At C384 that is ~24.8 MB ->
// 7.4 us (stage 1) and ~35.4 MB -> 10.6 us (stages 2-3) at 3.35 TB/s,
// against ~1.8 us of float32 arithmetic at 67 TFLOP/s: bound by memory.
// This first design is simple and right; it has no matrix products, so
// wgmma does not apply.  TMA / cp.async staging and occupancy tuning are
// for later.

#include "cov_common.cuh"

namespace {

using namespace cov;

constexpr int AP = 2;      // h apron: PLR reads two cells past a face

struct Params {
  const float* h0;   // (6, n, n) stage base, read only if with_y0
  const float* u0;   // (2, 6, n, n)
  const float* hc;   // (6, n, n) current stage
  const float* uc;   // (2, 6, n, n)
  const float* gsn;  // (6, 6h+2, n) routed S/N ghosts + sym rows
  const float* gwe;  // (6, n, 6h+2) routed W/E ghosts + sym columns
  const float* b;    // (6, m, m) orography, ghosts filled
  const float* xc;   // (m,) tan of the cell-center coordinates
  const float* xf;   // (m,) tan of the left-face coordinates
  const float* fz;   // (6, 3) face-frame z components (c0, cx, cy)
  float* ho;         // (6, n, n)
  float* uo;         // (2, 6, n, n)
  float* ssn;        // (6, 6h, n)
  float* swe;        // (6, n, 6h)
  int n, halo, with_y0;
  float R2, gravity, two_omega, inv2d, inv_d, a, bcoef, g_dt;
};

// At least 4 resident blocks per SM caps the kernel at 64 registers.
// Left to itself nvcc took 66, which allows only 3 blocks of 256 threads
// per SM, and the stage ran ~18% slower on the H100.
__global__ void __launch_bounds__(BX * BY, 4)
cov_stage_kernel(const Params p) {
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

  // ---- 1. stage the tile with its aprons (ghost corners as 0) ---------
  for (int ly = ty; ly < TY + 2 * AP; ly += BY)
    for (int lx = tx; lx < TX + 2 * AP; lx += BX)
      s_h[ly][lx] = edge_fetch(hc, gsn, gwe, 0, n, hh, rw, j0 + ly - AP,
                               i0 + lx - AP);
  for (int ly = ty; ly < TY + 2; ly += BY)
    for (int lx = tx; lx < TX + 2; lx += BX) {
      const int j = j0 + ly - 1, i = i0 + lx - 1;
      s_ua[ly][lx] = edge_fetch(ua, gsn, gwe, 1, n, hh, rw, j, i);
      s_ub[ly][lx] = edge_fetch(ub, gsn, gwe, 2, n, hh, rw, j, i);
    }
  __syncthreads();

  // ---- 2. tendencies, RK combine, state and strip stores --------------
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
        const float vals[3] = {
            combine(p.with_y0, p.a, p.bcoef, p.g_dt, y0h,
                    s_h[ly + AP][lx + AP], dh),
            combine(p.with_y0, p.a, p.bcoef, p.g_dt, y0a,
                    s_ua[ly + 1][lx + 1], dua),
            combine(p.with_y0, p.a, p.bcoef, p.g_dt, y0b,
                    s_ub[ly + 1][lx + 1], dub)};
        p.ho[c] = vals[0];
        p.uo[c] = vals[1];
        p.uo[6 * nn + c] = vals[2];
        for (int fi = 0; fi < 3; ++fi)
          put_strips(ssn, swe, fi, n, hh, j, i, vals[fi]);
      });
}

}  // namespace

// Launches one stage on `stream`; returns cudaGetLastError() (0 = ok).
// with_y0 == 0: yc + g_dt*L (stage 1); with_y0 != 0: (a*y0 + b*yc) +
// g_dt*L (stages 2-3; h0/u0 read only then).  All tensors float32,
// contiguous, in the layouts of Params.
extern "C" int cov_stage_compact_f32(
    const float* h0, const float* u0, const float* hc, const float* uc,
    const float* gsn, const float* gwe, const float* b_ext,
    const float* xc, const float* xf, const float* fz,
    float* ho, float* uo, float* ssn, float* swe,
    int n, int halo, int with_y0,
    float R2, float gravity, float two_omega, float inv2d, float inv_d,
    float a, float b, float g_dt, void* stream) {
  Params p{h0, u0, hc, uc, gsn, gwe, b_ext, xc, xf, fz, ho, uo, ssn, swe,
           n, halo, with_y0, R2, gravity, two_omega, inv2d, inv_d, a, b, g_dt};
  const dim3 grid((n + TX - 1) / TX, (n + TY - 1) / TY, 6);
  const dim3 block(BX, BY);
  cov_stage_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
