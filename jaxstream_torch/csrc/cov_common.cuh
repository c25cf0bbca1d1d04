// Device code shared by the covariant shallow-water kernels of
// jaxstream_torch: the routed-ghost fetch, the PLR-MC upwind flux, the
// closed-form metric terms (_fast_frame), the conservative Laplacian
// (lap_core) and the advective stage on one tile (rhs_core_cov + the
// RK combine's operands).  Every function reproduces the plain PyTorch
// version's operations in its order; the kernels are built with
// -fmad=false, so each multiply and add rounds separately, as PyTorch's
// do.  Everything is __forceinline__: each kernel compiles to the code it
// would have with the functions written out in it.

#pragma once

#include <cuda_runtime.h>

namespace cov {

constexpr int TX = 32;     // output tile width along alpha (i)
constexpr int TY = 16;     // output tile height along beta (j)
constexpr int BX = 32;     // threads along i
constexpr int BY = 8;      // threads along j

// Field fi at face-local (j, i): the interior q, or an edge ghost from the
// routed blocks gsn (6h+2, n) / gwe (n, 6h+2) of the face (field fi at
// rows/columns fi*2h .. fi*2h+2h, S|N and W|E).  0 at a ghost corner or
// past the ghost ring.
__device__ __forceinline__ float edge_fetch(const float* __restrict__ q,
                                            const float* __restrict__ gsn,
                                            const float* __restrict__ gwe,
                                            int fi, int n, int hh, int rw,
                                            int j, int i) {
  const bool jin = j >= 0 && j < n;
  const bool iin = i >= 0 && i < n;
  if (jin && iin) return q[j * n + i];
  if (iin) {
    if (j < 0 && j >= -hh) return gsn[(fi * 2 * hh + (j + hh)) * n + i];
    if (j >= n && j < n + hh) return gsn[(fi * 2 * hh + hh + (j - n)) * n + i];
  } else if (jin) {
    if (i < 0 && i >= -hh) return gwe[j * rw + fi * 2 * hh + (i + hh)];
    if (i >= n && i < n + hh) return gwe[j * rw + fi * 2 * hh + hh + (i - n)];
  }
  return 0.0f;
}

// The halo-deep frame as _fill(corners=True) builds it: edge_fetch, and
// each h x h ghost corner the average 0.5 (S/N ghost at the nearest
// interior column + W/E ghost at the nearest interior row).  Cells past
// the frame are 0 and feed no kept output.
__device__ __forceinline__ float filled(const float* __restrict__ q,
                                        const float* __restrict__ gsn,
                                        const float* __restrict__ gwe,
                                        int fi, int n, int hh, int rw,
                                        int j, int i) {
  const bool jout = j < 0 || j >= n;
  const bool iout = i < 0 || i >= n;
  if (jout && iout) {
    if (j < -hh || j >= n + hh || i < -hh || i >= n + hh) return 0.0f;
    const int ie = i < 0 ? 0 : n - 1;
    const int je = j < 0 ? 0 : n - 1;
    return 0.5f * (edge_fetch(q, gsn, gwe, fi, n, hh, rw, j, ie)
                   + edge_fetch(q, gsn, gwe, fi, n, hh, rw, je, i));
  }
  return edge_fetch(q, gsn, gwe, fi, n, hh, rw, j, i);
}

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

// The metric terms of cell (j, i), evaluated in place (xc, xf: the
// extended grid's center and left-face tan coordinates).
__device__ __forceinline__ CellMetric cell_metric(const float* __restrict__ xc,
                                                  const float* __restrict__ xf,
                                                  int hh, int j, int i,
                                                  float R2, float invd) {
  CellMetric c;
  xface_metric(xf[i + hh], xc[j + hh], c.xa_l, c.xb_l);
  xface_metric(xf[i + 1 + hh], xc[j + hh], c.xa_r, c.xb_r);
  yface_metric(xc[i + hh], xf[j + hh], c.ya_b, c.yb_b);
  yface_metric(xc[i + hh], xf[j + 1 + hh], c.ya_t, c.yb_t);
  c.isg = center_isg(xc[i + hh], xc[j + hh], R2, invd);
  return c;
}

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

// ---- the del^4 filter's windows (_nu4_filtered_value) --------------------

// The filter's shared windows around the TX x TY tile, for filtered values
// on the tile plus an apron A: psi (the halo-deep frame of h, u_a, u_b)
// on tile + A + 2, and l1 = lap(psi) on tile + A + 1, the face's ring-1
// window [-1, n]^2 clipped to it.
template <int A>
struct Nu4Window {
  static constexpr int LX = TX + 2 * A + 2, LY = TY + 2 * A + 2;
  static constexpr int PX = LX + 2, PY = LY + 2;
  float psi[3][PY][PX];
  float l1[3][LY][LX];
};

// The face metric terms of l1's window, which both Laplacians read (they
// do not depend on the field).  x-face k is the left face of window
// column k, y-face k the lower face of row k.
template <int A>
struct Nu4Metric {
  static constexpr int LX = Nu4Window<A>::LX, LY = Nu4Window<A>::LY;
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

// Fills w.psi from the interiors q[3] and the face's routed ghosts (with
// averaged corners: the cross-derivative terms read them), the metric
// terms, then w.l1: on the ghost ring l1 is the face-local operator at
// the ghost positions (the JAX design, so the second Laplacian needs no
// exchange).  Every thread of the block must call it: it synchronises,
// and on return w and mt are complete.
template <int A>
__device__ __forceinline__ void nu4_window(
    Nu4Window<A>& w, Nu4Metric<A>& mt, const float* const* q,
    const float* __restrict__ gsn, const float* __restrict__ gwe,
    const float* __restrict__ xc, const float* __restrict__ xf, int n,
    int hh, int j0, int i0, float R2, float invd, float inv2d) {
  using W = Nu4Window<A>;
  const int rw = 6 * hh + 2;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int pj = j0 - (A + 2), pi = i0 - (A + 2);   // psi window origin
  const int lj = j0 - (A + 1), li = i0 - (A + 1);   // l1 window origin
  for (int ly = ty; ly < W::PY; ly += BY)
    for (int lx = tx; lx < W::PX; lx += BX)
      for (int fi = 0; fi < 3; ++fi)
        w.psi[fi][ly][lx] = filled(q[fi], gsn, gwe, fi, n, hh, rw, pj + ly,
                                   pi + lx);
  // x-faces between columns c-1 | c, on rows r in [-1, n].
  for (int wy = ty; wy < W::LY; wy += BY)
    for (int k = tx; k < W::LX + 1; k += BX) {
      const int r = lj + wy, c = li + k;
      float fa = 0.0f, fb = 0.0f;
      if (r >= -1 && r <= n && c >= -1 && c <= n + 1)
        xface_metric(xf[c + hh], xc[r + hh], fa, fb);
      mt.xa[wy][k] = fa;
      mt.xb[wy][k] = fb;
    }
  // y-faces between rows r-1 | r, on columns c in [-1, n].
  for (int k = ty; k < W::LY + 1; k += BY)
    for (int wx = tx; wx < W::LX; wx += BX) {
      const int r = lj + k, c = li + wx;
      float fa = 0.0f, fb = 0.0f;
      if (r >= -1 && r <= n + 1 && c >= -1 && c <= n)
        yface_metric(xc[c + hh], xf[r + hh], fa, fb);
      mt.ya[k][wx] = fa;
      mt.yb[k][wx] = fb;
    }
  for (int wy = ty; wy < W::LY; wy += BY)
    for (int wx = tx; wx < W::LX; wx += BX) {
      const int r = lj + wy, c = li + wx;
      mt.isg[wy][wx] = (r >= -1 && r <= n && c >= -1 && c <= n)
                           ? center_isg(xc[c + hh], xc[r + hh], R2, invd)
                           : 0.0f;
    }
  __syncthreads();

  for (int wy = ty; wy < W::LY; wy += BY)
    for (int wx = tx; wx < W::LX; wx += BX) {
      const int r = lj + wy, c = li + wx;
      const bool ok = r >= -1 && r <= n && c >= -1 && c <= n;
      const CellMetric cm = mt.at(wy, wx);
      for (int fi = 0; fi < 3; ++fi)
        w.l1[fi][wy][wx] =
            ok ? lap_at<W::PX>(&w.psi[fi][0][0], wy + 1, wx + 1, cm, invd,
                               inv2d)
               : 0.0f;
    }
  __syncthreads();
}

// q - damp * lap(l1) of field fi at cell (oy, ox) of the tile + A window,
// whose metric terms are cm = mt.at(oy + 1, ox + 1).
template <int A>
__device__ __forceinline__ float nu4_filtered(const Nu4Window<A>& w, int fi,
                                              int oy, int ox,
                                              const CellMetric& cm,
                                              float invd, float inv2d,
                                              float damp) {
  const float l2 = lap_at<Nu4Window<A>::LX>(&w.l1[fi][0][0], oy + 1, ox + 1,
                                            cm, invd, inv2d);
  return w.psi[fi][oy + 2][ox + 2] - damp * l2;
}

// ---- the advective stage on one tile (rhs_core_cov) -----------------------

// Shared scratch of advective_tile: the Bernoulli band, the contravariant
// velocities of the tile and the face fluxes (19 KB).
struct AdvScratch {
  float bern[TY + 2][TX + 2];
  float uca[TY][TX];
  float ucb[TY][TX];
  float fx[TY][TX + 1];
  float fy[TY + 1][TX];
};

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

// The covariant right-hand side of the TX x TY tile at (j0, i0) of face f
// (rhs_core_cov).  It reads h from the shared window sh (row stride SH;
// tile cell (y, x) at sh[(y+2)*SH + x+2], a 2-deep apron) and u_a, u_b
// from sua, sub (stride SU; tile cell at [(y+1)*SU + x+1], a 1-deep
// apron), all filled by the caller and synchronised.  The apron's
// diagonal cells are never read by a kept output.  sym gives the face's
// symmetrized edge normals imposed on the boundary faces: as they are
// when Prescaled (sym_prescaled=True), else times the edge sqrtg of the
// closed-form frame (sg * sym); bf is the face's (m, m) orography.  For
// every interior cell of the tile it calls epi(ly, lx, j, i, dh, dua,
// dub).  Every thread of the block must call it: it synchronises.
template <bool Prescaled, int SH, int SU, class Epilogue>
__device__ __forceinline__ void advective_tile(
    const float* sh, const float* sua, const float* sub, AdvScratch& s,
    const SymRows& sym, const float* __restrict__ bf,
    const float* __restrict__ xc, const float* __restrict__ xf,
    const float* __restrict__ fz, const StageConsts& k, int n, int hh,
    int j0, int i0, Epilogue epi) {
  const int m = n + 2 * hh;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const float R2 = k.R2;
  // Window accessors in tile coordinates.
  auto H = [&](int y, int x) { return sh[(y + 2) * SH + x + 2]; };
  auto UA = [&](int y, int x) { return sua[(y + 1) * SU + x + 1]; };
  auto UB = [&](int y, int x) { return sub[(y + 1) * SU + x + 1]; };

  // ---- Bernoulli function and contravariant u on the band -------------
  for (int ly = ty; ly < TY + 2; ly += BY)
    for (int lx = tx; lx < TX + 2; lx += BX) {
      const int j = j0 + ly - 1, i = i0 + lx - 1;
      const bool jin = j >= 0 && j < n, iin = i >= 0 && i < n;
      float bern = 0.0f;
      if (j >= -1 && j <= n && i >= -1 && i <= n && (jin || iin)) {
        const float x = xc[i + hh], y = xc[j + hh];
        const float dxda = 1.0f + x * x;
        const float dydb = 1.0f + y * y;
        const float rho2 = dxda + y * y;
        const float inv_R2dxda = 1.0f / (R2 * dxda);
        const float inv_dydb = 1.0f / dydb;
        const float g_aa = rho2 * inv_R2dxda;
        const float g_bb = (rho2 * inv_R2dxda) * (dxda * inv_dydb);
        const float g_ab = rho2 * ((x * inv_R2dxda) * (y * inv_dydb));
        const float va = UA(ly - 1, lx - 1), vb = UB(ly - 1, lx - 1);
        const float uca = g_aa * va + g_ab * vb;
        const float ucb = g_ab * va + g_bb * vb;
        const float ke = 0.5f * (uca * va + ucb * vb);
        bern = k.gravity * (H(ly - 1, lx - 1) + bf[(j + hh) * m + i + hh])
             + ke;
        if (ly >= 1 && ly <= TY && lx >= 1 && lx <= TX) {
          s.uca[ly - 1][lx - 1] = uca;
          s.ucb[ly - 1][lx - 1] = ucb;
        }
      }
      s.bern[ly][lx] = bern;
    }

  // ---- mass fluxes through the alpha-faces (i) and beta-faces (j) -----
  for (int ly = ty; ly < TY; ly += BY)
    for (int lf = tx; lf < TX + 1; lf += BX) {
      const int j = j0 + ly, i = i0 + lf;   // face i: cells i-1 | i
      float flux = 0.0f;
      if (j < n && i <= n) {
        float U;
        if (i == 0 || i == n) {              // W / E seam
          U = (i == 0 ? sym.w : sym.e)[j * sym.ws];
          if (!Prescaled) U = frame_sqrtg(xf[i + hh], xc[j + hh], R2) * U;
        } else {
          float fg_aa, fg_ab;
          xface_metric(xf[i + hh], xc[j + hh], fg_aa, fg_ab);
          const float uba = 0.5f * (UA(ly, lf - 1) + UA(ly, lf));
          const float ubb = 0.5f * (UB(ly, lf - 1) + UB(ly, lf));
          U = fg_aa * uba + fg_ab * ubb;
        }
        flux = upwind_flux(U, H(ly, lf - 2), H(ly, lf - 1), H(ly, lf),
                           H(ly, lf + 1));
      }
      s.fx[ly][lf] = flux;
    }
  for (int lf = ty; lf < TY + 1; lf += BY)
    for (int lx = tx; lx < TX; lx += BX) {
      const int j = j0 + lf, i = i0 + lx;   // face j: cells j-1 | j
      float flux = 0.0f;
      if (j <= n && i < n) {
        float U;
        if (j == 0 || j == n) {              // S / N seam
          U = (j == 0 ? sym.s : sym.n)[i];
          if (!Prescaled) U = frame_sqrtg(xc[i + hh], xf[j + hh], R2) * U;
        } else {
          float fg_ab, fg_bb;
          yface_metric(xc[i + hh], xf[j + hh], fg_ab, fg_bb);
          const float vba = 0.5f * (UA(lf - 1, lx) + UA(lf, lx));
          const float vbb = 0.5f * (UB(lf - 1, lx) + UB(lf, lx));
          U = fg_ab * vba + fg_bb * vbb;
        }
        flux = upwind_flux(U, H(lf - 2, lx), H(lf - 1, lx), H(lf, lx),
                           H(lf + 1, lx));
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
      const float dxda = 1.0f + x * x;
      const float dydb = 1.0f + y * y;
      const float rho2 = dxda + y * y;
      const float inv_rho = rsqrtf(rho2);
      const float inv_rho2 = inv_rho * inv_rho;
      const float sg_row = R2 * dxda;
      const float sqrtg = (sg_row * dydb) * (inv_rho2 * inv_rho);
      const float inv_sqrtg = ((1.0f / sg_row) * (1.0f / dydb))
                            * (rho2 * rho2 * inv_rho);

      const float dh = -((s.fx[ly][lx + 1] - s.fx[ly][lx])
                         + (s.fy[ly + 1][lx] - s.fy[ly][lx]))
                     * (inv_sqrtg * k.inv_d);
      const float dba = (s.bern[ly + 1][lx + 2] - s.bern[ly + 1][lx])
                      * k.inv2d;
      const float dbb = (s.bern[ly + 2][lx + 1] - s.bern[ly][lx + 1])
                      * k.inv2d;
      const float dub_da = (UB(ly, lx + 1) - UB(ly, lx - 1)) * k.inv2d;
      const float dua_db = (UA(ly + 1, lx) - UA(ly - 1, lx)) * k.inv2d;
      const float rz = ((fz[0] + x * fz[1]) + y * fz[2]) * inv_rho;
      const float absv = (dub_da - dua_db) + (k.two_omega * rz) * sqrtg;
      const float dua = absv * s.ucb[ly][lx] - dba;
      const float dub = (-absv) * s.uca[ly][lx] - dbb;
      epi(ly, lx, j, i, dh, dua, dub);
    }
}

}  // namespace cov
