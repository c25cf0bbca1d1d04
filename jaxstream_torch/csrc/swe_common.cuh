// Device code shared by the Cartesian shallow-water kernels of
// jaxstream_torch (swe_rhs.cu, swe_stage.cu, swe_stage_inkernel.cu): the
// two metric cores of jaxstream_torch.ops.cuda.swe_rhs (the general basis
// _basis of rhs_core, the orthonormal-frame closed forms _fast_frame of
// rhs_core_fast) and the Cartesian RHS of one tile.  The PLR-MC upwind
// flux, the tile shape and the RK combine come from cov_common.cuh.
// Every function reproduces the plain PyTorch version's operations in
// its order; the kernels are built with -fmad=false, so each multiply and
// add rounds separately, as PyTorch's do.

#pragma once

#include "cov_common.cuh"

namespace swe {

using cov::BX;
using cov::BY;
using cov::TX;
using cov::TY;

// Per-launch constants of the Cartesian RHS, float32 as the plain
// version rounds them: R, R*R, g, 2 Omega, 1/(2d), 1/d.
struct Consts {
  float R, R2, gravity, two_omega, inv2d, inv_d;
};

// ---- the general basis (_basis) ------------------------------------------

// What every _basis evaluation at (X, Y) = (x, y) starts from.
struct Prelude {
  float inv_rho, inv_rho2, dxda, dydb;
};

__device__ __forceinline__ Prelude prelude(float x, float y) {
  const float x2 = x * x;
  const float y2 = y * y;
  const float rho2 = (1.0f + x2) + y2;
  Prelude p;
  p.inv_rho = rsqrtf(rho2);
  p.inv_rho2 = p.inv_rho * p.inv_rho;
  p.dxda = 1.0f + x2;
  p.dydb = 1.0f + y2;
  return p;
}

// rhat = ((c0 + X cx) + Y cy) / rho; fr holds c0, cx, cy (9 floats).
__device__ __forceinline__ void basis_rhat(const float* fr, float x, float y,
                                           const Prelude& p, float* rhat) {
  for (int c = 0; c < 3; ++c)
    rhat[c] = ((fr[c] + x * fr[3 + c]) + y * fr[6 + c]) * p.inv_rho;
}

__device__ __forceinline__ float basis_sqrtg(const Prelude& p,
                                             const Consts& k) {
  return (((k.R2 * p.dxda) * p.dydb) * p.inv_rho) * p.inv_rho2;
}

// The covariant basis e_a, e_b from rhat.
__device__ __forceinline__ void basis_e(const float* fr, const float* rhat,
                                        const Prelude& p, const Consts& k,
                                        float* e_a, float* e_b) {
  const float pcx = (rhat[0] * fr[3] + rhat[1] * fr[4]) + rhat[2] * fr[5];
  const float pcy = (rhat[0] * fr[6] + rhat[1] * fr[7]) + rhat[2] * fr[8];
  const float fa = (k.R * p.dxda) * p.inv_rho;
  const float fb = (k.R * p.dydb) * p.inv_rho;
  for (int c = 0; c < 3; ++c) {
    e_a[c] = fa * (fr[3 + c] - rhat[c] * pcx);
    e_b[c] = fb * (fr[6 + c] - rhat[c] * pcy);
  }
}

// The dual basis a_a, a_b from e_a, e_b through the closed-form 2x2
// metric and its determinant.
__device__ __forceinline__ void basis_a(const float* e_a, const float* e_b,
                                        float x, float y, const Prelude& p,
                                        const Consts& k, float* a_a,
                                        float* a_b) {
  const float inv_rho4 = p.inv_rho2 * p.inv_rho2;
  const float gcom = ((k.R2 * p.dxda) * p.dydb) * inv_rho4;
  const float gaa = gcom * p.dxda;
  const float gbb = gcom * p.dydb;
  const float gab = ((-gcom) * x) * y;
  const float inv_det = 1.0f / (gaa * gbb - gab * gab);
  const float inv_aa = gbb * inv_det;
  const float inv_ab = (-gab) * inv_det;
  const float inv_bb = gaa * inv_det;
  for (int c = 0; c < 3; ++c) {
    if (a_a) a_a[c] = inv_aa * e_a[c] + inv_ab * e_b[c];
    if (a_b) a_b[c] = inv_ab * e_a[c] + inv_bb * e_b[c];
  }
}

// ---- the orthonormal-frame closed forms (_fast_frame) -------------------

struct Fast {
  float inv_rho, inv_rho2, fa, fb, inv_aa, inv_bb, inv_ab, sqrtg, inv_sqrtg;
};

__device__ __forceinline__ Fast fast_frame(float x, float y,
                                           const Consts& k) {
  const float x2 = x * x;
  const float y2 = y * y;
  const float dxda = 1.0f + x2;
  const float dydb = 1.0f + y2;
  const float rho2 = dxda + y2;
  Fast F;
  F.inv_rho = rsqrtf(rho2);
  F.inv_rho2 = F.inv_rho * F.inv_rho;
  const float inv_R2dxda = 1.0f / (k.R2 * dxda);
  const float inv_dydb = 1.0f / dydb;
  const float sg_row = k.R2 * dxda;
  F.fa = (k.R * dxda) * F.inv_rho;
  F.fb = (k.R * dydb) * F.inv_rho;
  F.inv_aa = rho2 * inv_R2dxda;
  F.inv_bb = (rho2 * inv_R2dxda) * (dxda * inv_dydb);
  F.inv_ab = rho2 * ((x * inv_R2dxda) * (y * inv_dydb));
  F.sqrtg = (sg_row * dydb) * (F.inv_rho2 * F.inv_rho);
  F.inv_sqrtg = ((1.0f / sg_row) * inv_dydb) * ((rho2 * rho2) * F.inv_rho);
  return F;
}

// (v.e_a, v.e_b) of a Cartesian v through the frame dots (rhs_core_fast's
// dots + covariant).
__device__ __forceinline__ void fast_covariant(const float* fr,
                                               const float* v, float x,
                                               float y, const Fast& F,
                                               float& vea, float& veb) {
  const float d0 = (v[0] * fr[0] + v[1] * fr[1]) + v[2] * fr[2];
  const float dxx = (v[0] * fr[3] + v[1] * fr[4]) + v[2] * fr[5];
  const float dyy = (v[0] * fr[6] + v[1] * fr[7]) + v[2] * fr[8];
  const float vp = (d0 + x * dxx) + y * dyy;
  const float u = vp * F.inv_rho2;
  vea = F.fa * (dxx - x * u);
  veb = F.fb * (dyy - y * u);
}

// ---- the RHS of one tile -------------------------------------------------

// Shared scratch of swe_tile: the covariant components and the Bernoulli
// function on the band (tile + 1 ring), and the face fluxes.
struct Scratch {
  float va[TY + 2][TX + 2];
  float vb[TY + 2][TX + 2];
  float bern[TY + 2][TX + 2];
  float fx[TY][TX + 1];
  float fy[TY + 1][TX];
};

// sqrtg * u^alpha at the x-face (X, Y) = (x, y) of the face-averaged
// Cartesian velocity v, and the face's sqrtg factor: the general core
// returns u^alpha = v . a_a and sqrtg, the fast core the same through
// its closed forms.  Along beta (Alpha = false) the same at a y-face.
template <bool Fast_, bool Alpha>
__device__ __forceinline__ void face_velocity(const float* fr, const float* v,
                                              float x, float y,
                                              const Consts& k, float& u,
                                              float& sg) {
  if (Fast_) {
    const Fast F = fast_frame(x, y, k);
    float vea, veb;
    fast_covariant(fr, v, x, y, F, vea, veb);
    u = Alpha ? F.inv_aa * vea + F.inv_ab * veb
              : F.inv_ab * vea + F.inv_bb * veb;
    sg = F.sqrtg;
  } else {
    const Prelude p = prelude(x, y);
    float rhat[3], e_a[3], e_b[3], a[3];
    basis_rhat(fr, x, y, p, rhat);
    basis_e(fr, rhat, p, k, e_a, e_b);
    basis_a(e_a, e_b, x, y, p, k, Alpha ? a : nullptr, Alpha ? nullptr : a);
    u = (v[0] * a[0] + v[1] * a[1]) + v[2] * a[2];
    sg = basis_sqrtg(p, k);
  }
}

// The Cartesian right-hand side of the TX x TY tile at (j0, i0) of one
// face (rhs_core_fast when Fast_, else rhs_core).  It reads h from the
// shared window sh (row stride TX + 4; tile cell (y, x) at
// sh[(y+2)*(TX+4) + x+2], a 2-deep apron) and the Cartesian components
// from sv (three windows of (TY+2) x (TX+2), a 1-deep apron), both filled
// by the caller and synchronised; fr is the face frame (c0, cx, cy), bf
// the face's (m, m) orography.  The apron's diagonal cells are never
// read by a kept output.  For every interior cell of the tile it calls
// epi(ly, lx, j, i, dh, dv0, dv1, dv2).  Every thread of the block must
// call it: it synchronises.
template <bool Fast_, class Epilogue>
__device__ __forceinline__ void swe_tile(const float* sh, const float* sv,
                                         Scratch& s, const float* fr,
                                         const float* __restrict__ bf,
                                         const float* __restrict__ xc,
                                         const float* __restrict__ xf,
                                         const Consts& k, int n, int hh,
                                         int j0, int i0, Epilogue epi) {
  constexpr int SH = TX + 4, SV = TX + 2, PV = (TY + 2) * (TX + 2);
  const int m = n + 2 * hh;
  const int tx = threadIdx.x, ty = threadIdx.y;
  auto H = [&](int y, int x) { return sh[(y + 2) * SH + x + 2]; };
  auto V = [&](int c, int y, int x) {
    return sv[c * PV + (y + 1) * SV + x + 1];
  };

  // ---- covariant components and Bernoulli function on the band ---------
  for (int ly = ty; ly < TY + 2; ly += BY)
    for (int lx = tx; lx < TX + 2; lx += BX) {
      const int j = j0 + ly - 1, i = i0 + lx - 1;
      const bool jin = j >= 0 && j < n, iin = i >= 0 && i < n;
      float va = 0.0f, vb = 0.0f, bern = 0.0f;
      if (j >= -1 && j <= n && i >= -1 && i <= n && (jin || iin)) {
        const float x = xc[i + hh], y = xc[j + hh];
        const float v[3] = {V(0, ly - 1, lx - 1), V(1, ly - 1, lx - 1),
                            V(2, ly - 1, lx - 1)};
        if (Fast_) {
          fast_covariant(fr, v, x, y, fast_frame(x, y, k), va, vb);
        } else {
          const Prelude p = prelude(x, y);
          float rhat[3], e_a[3], e_b[3];
          basis_rhat(fr, x, y, p, rhat);
          basis_e(fr, rhat, p, k, e_a, e_b);
          va = (v[0] * e_a[0] + v[1] * e_a[1]) + v[2] * e_a[2];
          vb = (v[0] * e_b[0] + v[1] * e_b[1]) + v[2] * e_b[2];
        }
        const float ke = 0.5f * ((v[0] * v[0] + v[1] * v[1]) + v[2] * v[2]);
        bern = k.gravity * (H(ly - 1, lx - 1) + bf[(j + hh) * m + i + hh])
             + ke;
      }
      s.va[ly][lx] = va;
      s.vb[ly][lx] = vb;
      s.bern[ly][lx] = bern;
    }

  // ---- mass fluxes through the alpha-faces (i) and beta-faces (j) -----
  for (int ly = ty; ly < TY; ly += BY)
    for (int lf = tx; lf < TX + 1; lf += BX) {
      const int j = j0 + ly, i = i0 + lf;   // face i: cells i-1 | i
      float flux = 0.0f;
      if (j < n && i <= n) {
        float v[3];
        for (int c = 0; c < 3; ++c)
          v[c] = 0.5f * (V(c, ly, lf - 1) + V(c, ly, lf));
        float u, sg;
        face_velocity<Fast_, true>(fr, v, xf[i + hh], xc[j + hh], k, u, sg);
        flux = sg * cov::upwind_flux(u, H(ly, lf - 2), H(ly, lf - 1),
                                     H(ly, lf), H(ly, lf + 1));
      }
      s.fx[ly][lf] = flux;
    }
  for (int lf = ty; lf < TY + 1; lf += BY)
    for (int lx = tx; lx < TX; lx += BX) {
      const int j = j0 + lf, i = i0 + lx;   // face j: cells j-1 | j
      float flux = 0.0f;
      if (j <= n && i < n) {
        float v[3];
        for (int c = 0; c < 3; ++c)
          v[c] = 0.5f * (V(c, lf - 1, lx) + V(c, lf, lx));
        float u, sg;
        face_velocity<Fast_, false>(fr, v, xc[i + hh], xf[j + hh], k, u,
                                    sg);
        flux = sg * cov::upwind_flux(u, H(lf - 2, lx), H(lf - 1, lx),
                                     H(lf, lx), H(lf + 1, lx));
      }
      s.fy[lf][lx] = flux;
    }
  __syncthreads();

  // ---- tendencies -------------------------------------------------------
  for (int ly = ty; ly < TY; ly += BY)
    for (int lx = tx; lx < TX; lx += BX) {
      const int j = j0 + ly, i = i0 + lx;
      if (j >= n || i >= n) continue;
      const float x = xc[i + hh], y = xc[j + hh];
      const float div = (s.fx[ly][lx + 1] - s.fx[ly][lx])
                      + (s.fy[ly + 1][lx] - s.fy[ly][lx]);
      const float dvb_da = (s.vb[ly + 1][lx + 2] - s.vb[ly + 1][lx]) * k.inv2d;
      const float dva_db = (s.va[ly + 2][lx + 1] - s.va[ly][lx + 1]) * k.inv2d;
      const float dpa = (s.bern[ly + 1][lx + 2] - s.bern[ly + 1][lx])
                      * k.inv2d;
      const float dpb = (s.bern[ly + 2][lx + 1] - s.bern[ly][lx + 1])
                      * k.inv2d;
      float dh, rk[3], grad[3], zeta;
      if (Fast_) {
        const Fast F = fast_frame(x, y, k);
        dh = (-div) * (F.inv_sqrtg * k.inv_d);
        zeta = (dvb_da - dva_db) * F.inv_sqrtg;
        // grad = A cx + B cy + C c0 in the constant frame.
        const float ca = F.inv_aa * dpa + F.inv_ab * dpb;
        const float cb = F.inv_ab * dpa + F.inv_bb * dpb;
        const float uu = ca * F.fa;
        const float ww = cb * F.fb;
        const float tt = (uu * x + ww * y) * F.inv_rho2;
        const float A = uu - tt * x;
        const float B = ww - tt * y;
        const float C = -tt;
        for (int c = 0; c < 3; ++c) {
          grad[c] = (A * fr[3 + c] + B * fr[6 + c]) + C * fr[c];
          rk[c] = F.inv_rho * ((fr[c] + x * fr[3 + c]) + y * fr[6 + c]);
        }
      } else {
        const Prelude p = prelude(x, y);
        float e_a[3], e_b[3], a_a[3], a_b[3];
        basis_rhat(fr, x, y, p, rk);
        basis_e(fr, rk, p, k, e_a, e_b);
        basis_a(e_a, e_b, x, y, p, k, a_a, a_b);
        const float inv_sg = 1.0f / basis_sqrtg(p, k);
        dh = (-div) * (inv_sg * k.inv_d);
        zeta = (dvb_da - dva_db) * inv_sg;
        for (int c = 0; c < 3; ++c)
          grad[c] = a_a[c] * dpa + a_b[c] * dpb;
      }
      const float absv = zeta + k.two_omega * rk[2];
      const float vi[3] = {V(0, ly, lx), V(1, ly, lx), V(2, ly, lx)};
      // Tangentialize, then k x v, then assemble and re-project.
      const float vdotk = (vi[0] * rk[0] + vi[1] * rk[1]) + vi[2] * rk[2];
      float vt[3];
      for (int c = 0; c < 3; ++c) vt[c] = vi[c] - rk[c] * vdotk;
      const float kxv[3] = {rk[1] * vt[2] - rk[2] * vt[1],
                            rk[2] * vt[0] - rk[0] * vt[2],
                            rk[0] * vt[1] - rk[1] * vt[0]};
      float dv[3];
      for (int c = 0; c < 3; ++c) dv[c] = (-absv) * kxv[c] - grad[c];
      const float dvdotk = (dv[0] * rk[0] + dv[1] * rk[1]) + dv[2] * rk[2];
      epi(ly, lx, j, i, dh, dv[0] - rk[0] * dvdotk, dv[1] - rk[1] * dvdotk,
          dv[2] - rk[2] * dvdotk);
    }
}

}  // namespace swe
