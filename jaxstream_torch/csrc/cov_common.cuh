// Device code shared by the covariant shallow-water kernels of
// jaxstream_torch: the boundary strips, the PLR-MC upwind flux, the RK
// combine, the closed-form metric terms (_fast_frame), the conservative
// Laplacian (lap_core) and the stage's constants and imposed edge
// normals.  Every function reproduces the plain PyTorch
// version's operations in its order; the kernels are built with
// -fmad=false, so each multiply and add rounds separately, as PyTorch's
// do.  Everything is __forceinline__: each kernel compiles to the code it
// would have with the functions written out in it.

#pragma once

#include <cuda_runtime.h>

namespace cov {

constexpr int BX = 32;     // threads along i
constexpr int BY = 8;      // threads along j

// Value v of field fi at interior cell (j, i) into the face's boundary
// strips ssn (6h, n) / swe (n, 6h), pack_strips_cov_split's layout.
__device__ __forceinline__ void put_strips(float* ssn, float* swe, int fi,
                                           int n, int hh, int j, int i,
                                           float v) {
  const int sw = 6 * hh;
  const int base = fi * 2 * hh;
  if (j < hh) ssn[(base + j) * n + i] = v;
  if (j >= n - hh) ssn[(base + hh + j - (n - hh)) * n + i] = v;
  if (i < hh) swe[(long)j * sw + base + i] = v;
  if (i >= n - hh) swe[(long)j * sw + base + hh + i - (n - hh)] = v;
}

// Monotonized-central slope, sign-free form (ops/reconstruct.py _slope_mc).
__device__ __forceinline__ float slope_mc(float dqm, float dqp) {
  const float a = 0.5f * (dqm + dqp);
  const float b = 2.0f * dqm;
  const float c = 2.0f * dqp;
  return fmaxf(fminf(fminf(a, b), c), 0.0f)
       + fminf(fmaxf(fmaxf(a, b), c), 0.0f);
}

// Upwind PLR flux through the face between cells q0 (= i-1) and q1 (= i)
// with neighbours qm (i-2) and qp (i+1); U is the sqrtg-folded normal
// velocity.
__device__ __forceinline__ float upwind_flux(float U, float qm, float q0,
                                             float q1, float qp) {
  const float qL = q0 + 0.5f * slope_mc(q0 - qm, q1 - q0);
  const float qR = q1 - 0.5f * slope_mc(q1 - q0, qp - q1);
  return fmaxf(U, 0.0f) * qL + fminf(U, 0.0f) * qR;
}

// The SSPRK3 combine: stage 1 yc + g_dt*L, stages 2-3 (a*y0 + b*yc) +
// g_dt*L.
__device__ __forceinline__ float combine(int with_y0, float a, float b,
                                         float g_dt, float y0, float yc,
                                         float tend) {
  if (with_y0) return (a * y0 + b * yc) + g_dt * tend;
  return yc + g_dt * tend;
}

// ---- closed-form metric terms (_fast_frame) ------------------------------

// fg_aa, fg_ab at an alpha-face with coordinates X = x, Y = y.
__device__ __forceinline__ void xface_metric(float x, float y, float& fg_aa,
                                             float& fg_ab) {
  const float y2 = y * y;
  const float dydb = 1.0f + y2;
  const float rho2 = (1.0f + x * x) + y2;
  const float inv_rho = rsqrtf(rho2);
  fg_aa = dydb * inv_rho;
  fg_ab = (x * y) * inv_rho;
}

// fg_ab, fg_bb at a beta-face.
__device__ __forceinline__ void yface_metric(float x, float y, float& fg_ab,
                                             float& fg_bb) {
  const float dxda = 1.0f + x * x;
  const float rho2 = dxda + y * y;
  const float inv_rho = rsqrtf(rho2);
  fg_ab = (x * y) * inv_rho;
  fg_bb = dxda * inv_rho;
}

// inv_sqrtg * (1/d) at a cell center.
__device__ __forceinline__ float center_isg(float x, float y, float R2,
                                            float invd) {
  const float dxda = 1.0f + x * x;
  const float dydb = 1.0f + y * y;
  const float rho2 = dxda + y * y;
  const float inv_rho = rsqrtf(rho2);
  const float sg_row = R2 * dxda;
  const float inv_sqrtg = ((1.0f / sg_row) * (1.0f / dydb))
                        * (rho2 * rho2 * inv_rho);
  return inv_sqrtg * invd;
}

// ---- the conservative Laplacian (lap_core) --------------------------------

// Face-normal metric terms of the four faces of one cell and its
// inv_sqrtg / d.
struct CellMetric {
  float xa_l, xb_l, xa_r, xb_r;   // x-faces: fg_aa, fg_ab (left, right)
  float yb_b, ya_b, yb_t, ya_t;   // y-faces: fg_bb, fg_ab (bottom, top)
  float isg;                      // inv_sqrtg * (1/d)
};

// lap_core at one cell of a shared window s (row stride S), centred at
// s[y][x]: face fluxes fg_aa d_a + fg_ab d_b (x-faces) and fg_bb d_b +
// fg_ab d_a (y-faces), the cross derivative averaged from the centered
// derivatives of the two abutting cells, the flux difference times
// inv_sqrtg / d.  invd = f32(1/d), inv2d = f32(0.5/d).
template <int S>
__device__ __forceinline__ float lap_at(const float* s, int y, int x,
                                        const CellMetric& c, float invd,
                                        float inv2d) {
  const float* p = s + y * S + x;
  const float dpbc_m = (p[S - 1] - p[-S - 1]) * inv2d;
  const float dpbc_0 = (p[S] - p[-S]) * inv2d;
  const float dpbc_p = (p[S + 1] - p[-S + 1]) * inv2d;
  const float fx_l = c.xa_l * ((p[0] - p[-1]) * invd)
                   + c.xb_l * (0.5f * (dpbc_m + dpbc_0));
  const float fx_r = c.xa_r * ((p[1] - p[0]) * invd)
                   + c.xb_r * (0.5f * (dpbc_0 + dpbc_p));
  const float dpac_m = (p[-S + 1] - p[-S - 1]) * inv2d;
  const float dpac_0 = (p[1] - p[-1]) * inv2d;
  const float dpac_p = (p[S + 1] - p[S - 1]) * inv2d;
  const float fy_b = c.yb_b * ((p[0] - p[-S]) * invd)
                   + c.ya_b * (0.5f * (dpac_m + dpac_0));
  const float fy_t = c.yb_t * ((p[S] - p[0]) * invd)
                   + c.ya_t * (0.5f * (dpac_0 + dpac_p));
  return ((fx_r - fx_l) + (fy_t - fy_b)) * c.isg;
}

// ---- the advective stage (rhs_core_cov) ----------------------------------

// Per-launch constants of the advective stage.
struct StageConsts {
  float R2, gravity, two_omega, inv2d, inv_d;
};

// The symmetrized edge normals imposed on one face's boundary fluxes:
// S[i] and N[i] along the S and N edges, W[j * ws] and E[j * ws] along W
// and E.
struct SymRows {
  const float* s;
  const float* n;
  const float* w;
  const float* e;
  int ws;
};

// The sym rows of the compact stages' routed ghosts gsn (6h+2, n) / gwe
// (n, 6h+2) of one face: its last two rows / columns.
__device__ __forceinline__ SymRows routed_sym(const float* __restrict__ gsn,
                                              const float* __restrict__ gwe,
                                              int n, int hh) {
  return SymRows{gsn + (6 * hh) * n, gsn + (6 * hh + 1) * n, gwe + 6 * hh,
                 gwe + 6 * hh + 1, 6 * hh + 2};
}

// sqrtg of the closed-form frame at the point (X, Y) = (x, y)
// (_fast_frame's "sqrtg").
__device__ __forceinline__ float frame_sqrtg(float x, float y, float R2) {
  const float dxda = 1.0f + x * x;
  const float dydb = 1.0f + y * y;
  const float rho2 = dxda + y * y;
  const float inv_rho = rsqrtf(rho2);
  const float inv_rho2 = inv_rho * inv_rho;
  return ((R2 * dxda) * dydb) * (inv_rho2 * inv_rho);
}

}  // namespace cov
