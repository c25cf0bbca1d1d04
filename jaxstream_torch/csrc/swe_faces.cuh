// Device code of the Cartesian kernels that take all faces of a tile in one
// block: the right-hand side of ghost-filled faces (swe_rhs.cu, B9), the
// concat-layout stage (swe_stage.cu, B10) and the in-kernel stage
// (swe_stage_inkernel.cu, B11).  cov_faces.cuh's design (a 32 x 24 tile
// position and a group of three faces per block, one tile column per lane,
// cp.async double buffering) for the Cartesian right-hand side of
// rhs_core_fast and rhs_core.  Every stored value is the float the plain
// version computes, with the same operations in the same order (built with
// -fmad=false), so the kernels stay bitwise equal to it.
//
// The metric once per tile.  fast_frame(x, y) does not read the face
// frame: all six faces of a tile position compute the same floats.  Of
// its terms, dxda, R dxda, 1/(R2 dxda), x/(R2 dxda) and R2 dxda depend on
// x alone, y2, dydb, R dydb, 1/dydb and y/dydb on y alone, and only
// inv_rho = rsqrtf(dxda + y2) on both.  A block computes those once per
// tile (SweMetric: 1-D tables along the band's and the faces' columns and
// rows, inv_rho at the band cells, x-faces and y-faces, 12.7 KB), and
// fast_at rebuilds the Fast fields from them with fast_frame's remaining
// multiplies in its order.  What reads the frame (fast_covariant, the
// gradient, rk, Coriolis) runs per face.  The general core (rhs_core,
// Fast_ = false) runs the same body with its basis per face in place, or
// with the basis's IEEE divisions (1/det g at the faces and centres,
// 1/sqrtg at the centres) read from a per-tile SweBasis (12.5 KB).

#pragma once

#include <type_traits>

#include "cov_faces.cuh"
#include "swe_common.cuh"

namespace swe {

using cov::FTX;
using cov::FTY;
using cov::FPB;
using cov::NT;
using cov::WOFF;
using cov::WS;
using cov::band_cell;
using cov::for_region;

// The x-only factors of fast_frame at N columns.
template <int N>
struct XRow {
  float x[N], dxda[N], Rdxda[N], sg[N], isg[N], xisg[N];
};

// The y-only factors of fast_frame at N rows.
template <int N>
struct YCol {
  float y[N], y2[N], dydb[N], Rdydb[N], idydb[N], yid[N];
};

// The face-independent metric terms of one tile: along the Bernoulli
// band's columns i0-1 .. i0+FTX (xc) and rows j0-1 .. j0+FTY (yc), along
// the x-faces' columns i0 .. i0+FTX (xf) and the y-faces' rows j0 ..
// j0+FTY (yf); inv_rho at the band cells (ly, lx), the x-faces (ly, lf)
// and the y-faces (lf, lx).  Entries that no kept output reads are 0.
struct SweMetric {
  XRow<FTX + 2> xc;
  XRow<FTX + 1> xf;
  YCol<FTY + 2> yc;
  YCol<FTY + 1> yf;
  float irho_b[FTY + 2][FTX + 2];
  float irho_x[FTY][FTX + 1];
  float irho_y[FTY + 1][FTX];
};

// One face's staged frame: h with a 2-deep apron, v0, v1, v2 with a
// 1-deep one (tile cell (y, x) at h[y + 2][WOFF + x], v[c][y + 1][WOFF +
// x]), and the orography on the band (cell (ly, lx) at (j0 + ly - 1, i0 +
// lx - 1)).
struct SweWindow {
  float h[FTY + 4][WS];
  float v[3][FTY + 2][WS];
  float b[FTY + 2][FTX + 2];
};

// The covariant components and the Bernoulli function on the band, and
// the face fluxes, of one face's tile.
struct SweScratch {
  float va[FTY + 2][FTX + 2];
  float vb[FTY + 2][FTX + 2];
  float bern[FTY + 2][FTX + 2];
  float fx[FTY][FTX + 1];
  float fy[FTY + 1][FTX];
};

__device__ __forceinline__ bool in_rows(int n, int hh, int k) {
  return k >= -hh && k < n + hh;
}

// Fills mt for the tile at (j0, i0) from the extended coordinate rows xc,
// xf (length n + 2 hh).  No barrier: the caller's next __syncthreads()
// publishes mt.
__device__ __forceinline__ void swe_metric(SweMetric& mt,
                                           const float* __restrict__ xc,
                                           const float* __restrict__ xf,
                                           const Consts& k, int n, int hh,
                                           int j0, int i0) {
  // The 1-D tables: one entry per thread.
  constexpr int NXC = FTX + 2, NXF = FTX + 1, NYC = FTY + 2, NYF = FTY + 1;
  const int t = cov::tid_y() * cov::BX + cov::tid_x();
  if (t < NXC + NXF) {
    const bool face = t >= NXC;
    const int e = face ? t - NXC : t;
    const int i = face ? i0 + e : i0 + e - 1;
    float x = 0.0f, dxda = 0.0f, Rdxda = 0.0f, sg = 0.0f, isg = 0.0f,
          xisg = 0.0f;
    if (in_rows(n, hh, i)) {
      x = (face ? xf : xc)[i + hh];
      dxda = 1.0f + x * x;
      Rdxda = k.R * dxda;
      sg = k.R2 * dxda;
      isg = 1.0f / sg;
      xisg = x * isg;
    }
    XRow<NXC>& rc = mt.xc;
    XRow<NXF>& rf = mt.xf;
    float* dst[6] = {face ? rf.x : rc.x, face ? rf.dxda : rc.dxda,
                     face ? rf.Rdxda : rc.Rdxda, face ? rf.sg : rc.sg,
                     face ? rf.isg : rc.isg, face ? rf.xisg : rc.xisg};
    const float val[6] = {x, dxda, Rdxda, sg, isg, xisg};
    for (int q = 0; q < 6; ++q) dst[q][e] = val[q];
  } else if (t < NXC + NXF + NYC + NYF) {
    const int u = t - NXC - NXF;
    const bool face = u >= NYC;
    const int e = face ? u - NYC : u;
    const int j = face ? j0 + e : j0 + e - 1;
    float y = 0.0f, y2 = 0.0f, dydb = 0.0f, Rdydb = 0.0f, idydb = 0.0f,
          yid = 0.0f;
    if (in_rows(n, hh, j)) {
      y = (face ? xf : xc)[j + hh];
      y2 = y * y;
      dydb = 1.0f + y2;
      Rdydb = k.R * dydb;
      idydb = 1.0f / dydb;
      yid = y * idydb;
    }
    YCol<NYC>& cc = mt.yc;
    YCol<NYF>& cf = mt.yf;
    float* dst[6] = {face ? cf.y : cc.y, face ? cf.y2 : cc.y2,
                     face ? cf.dydb : cc.dydb, face ? cf.Rdydb : cc.Rdydb,
                     face ? cf.idydb : cc.idydb, face ? cf.yid : cc.yid};
    const float val[6] = {y, y2, dydb, Rdydb, idydb, yid};
    for (int q = 0; q < 6; ++q) dst[q][e] = val[q];
  }
  // inv_rho = rsqrtf((1 + x^2) + y^2), fast_frame's rho2, in place.
  auto irho = [&](float x, float y) {
    const float y2 = y * y;
    return rsqrtf((1.0f + x * x) + y2);
  };
  for_region<FTY + 2, FTX + 2>([&](int ly, int lx) {
    const int j = j0 + ly - 1, i = i0 + lx - 1;
    mt.irho_b[ly][lx] =
        band_cell(n, j, i) ? irho(xc[i + hh], xc[j + hh]) : 0.0f;
  });
  for_region<FTY, FTX + 1>([&](int ly, int lf) {
    const int j = j0 + ly, i = i0 + lf;
    mt.irho_x[ly][lf] = (j < n && i <= n) ? irho(xf[i + hh], xc[j + hh])
                                          : 0.0f;
  });
  for_region<FTY + 1, FTX>([&](int lf, int lx) {
    const int j = j0 + lf, i = i0 + lx;
    mt.irho_y[lf][lx] = (j <= n && i < n) ? irho(xc[i + hh], xf[j + hh])
                                          : 0.0f;
  });
}

// fast_frame(X.x[ix], Y.y[iy]) from the tile's tables and its inv_rho:
// the same floats, by the same operations in the same order.
template <int NX, int NY>
__device__ __forceinline__ Fast fast_at(const XRow<NX>& X, int ix,
                                        const YCol<NY>& Y, int iy,
                                        float inv_rho) {
  const float rho2 = X.dxda[ix] + Y.y2[iy];
  Fast F;
  F.inv_rho = inv_rho;
  F.inv_rho2 = inv_rho * inv_rho;
  F.fa = X.Rdxda[ix] * inv_rho;
  F.fb = Y.Rdydb[iy] * inv_rho;
  F.inv_aa = rho2 * X.isg[ix];
  F.inv_bb = (rho2 * X.isg[ix]) * (X.dxda[ix] * Y.idydb[iy]);
  F.inv_ab = rho2 * (X.xisg[ix] * Y.yid[iy]);
  F.sqrtg = (X.sg[ix] * Y.dydb[iy]) * (F.inv_rho2 * inv_rho);
  F.inv_sqrtg = (X.isg[ix] * Y.idydb[iy]) * ((rho2 * rho2) * inv_rho);
  return F;
}

// The point (x, y) and its Fast terms at a band cell, an x-face or a
// y-face of the tile, from the tables.
struct TilePoints {
  const SweMetric& mt;

  __device__ __forceinline__ Fast band(int ly, int lx, float& x,
                                       float& y) const {
    x = mt.xc.x[lx];
    y = mt.yc.y[ly];
    return fast_at(mt.xc, lx, mt.yc, ly, mt.irho_b[ly][lx]);
  }

  __device__ __forceinline__ Fast xface(int ly, int lf, float& x,
                                        float& y) const {
    x = mt.xf.x[lf];
    y = mt.yc.y[ly + 1];
    return fast_at(mt.xf, lf, mt.yc, ly + 1, mt.irho_x[ly][lf]);
  }

  __device__ __forceinline__ Fast yface(int lf, int lx, float& x,
                                        float& y) const {
    x = mt.xc.x[lx + 1];
    y = mt.yf.y[lf];
    return fast_at(mt.xc, lx + 1, mt.yf, lf, mt.irho_y[lf][lx]);
  }
};

// Issues the copies of face f's window into w (no commit) from extended
// ghost-filled arrays: h (6, m, m), v (3, 6, m, m), b (6, m, m), m = n +
// 2 hh.  halo >= 2 puts every apron cell inside the m x m block; 0 past it
// (the ragged last tiles' aprons, which feed no kept output).
__device__ __forceinline__ void stage_frame_window(
    SweWindow& w, const float* __restrict__ h, const float* __restrict__ v,
    const float* __restrict__ b, int f, int n, int hh, int j0, int i0) {
  const long mm = (long)(n + 2 * hh) * (n + 2 * hh);
  cov::stage_frame<FTY + 4, 2>(&w.h[0][0], h + f * mm, n, hh, j0 - 2, i0);
  for (int c = 0; c < 3; ++c)
    cov::stage_frame<FTY + 2, 1>(&w.v[c][0][0], v + (c * 6 + f) * mm, n, hh,
                                 j0 - 1, i0);
  cov::stage_band(w.b, b + f * mm, n, hh, j0, i0);
}

// The general core's IEEE divisions at the tile's points, which do not
// read the face frame: 1/det g at the x-faces (ly, lf), the y-faces (lf,
// lx) and the centres (ly, lx), and 1/sqrtg at the centres.  Entries that
// no kept output reads are 0.
struct SweBasis {
  float idet_x[FTY][FTX + 1];
  float idet_y[FTY + 1][FTX];
  float idet_c[FTY][FTX];
  float isg_c[FTY][FTX];
};

// Fills bt for the tile at (j0, i0): each entry by the operations of
// face_velocity / the tendencies' basis, in their order.  No barrier: the
// caller's next __syncthreads() publishes bt.
__device__ __forceinline__ void swe_basis(SweBasis& bt,
                                          const float* __restrict__ xc,
                                          const float* __restrict__ xf,
                                          const Consts& k, int n, int hh,
                                          int j0, int i0) {
  auto idet = [&](float x, float y) {
    return basis_inv_det(basis_g(x, y, prelude(x, y), k));
  };
  for_region<FTY, FTX + 1>([&](int ly, int lf) {
    const int j = j0 + ly, i = i0 + lf;
    bt.idet_x[ly][lf] = (j < n && i <= n) ? idet(xf[i + hh], xc[j + hh])
                                          : 0.0f;
  });
  for_region<FTY + 1, FTX>([&](int lf, int lx) {
    const int j = j0 + lf, i = i0 + lx;
    bt.idet_y[lf][lx] = (j <= n && i < n) ? idet(xc[i + hh], xf[j + hh])
                                          : 0.0f;
  });
  for_region<FTY, FTX>([&](int ly, int lx) {
    const int j = j0 + ly, i = i0 + lx;
    float det = 0.0f, isg = 0.0f;
    if (j < n && i < n) {
      const float x = xc[i + hh], y = xc[j + hh];
      const Prelude p = prelude(x, y);
      det = basis_inv_det(basis_g(x, y, p, k));
      isg = 1.0f / basis_sqrtg(p, k);
    }
    bt.idet_c[ly][lx] = det;
    bt.isg_c[ly][lx] = isg;
  });
}

// The Cartesian right-hand side of one face's tile from its staged window
// w (synchronised): the fast core (rhs_core_fast) when Fast_, from the
// tile's SweMetric mt; else the general core (rhs_core), whose divisions
// come from mt when it is the tile's SweBasis and are computed per face
// for any other mt (unread then).  fr is the face frame (c0, cx, cy).
// For every interior cell it calls epi(r, ly, lx, j, i, dh, dv0, dv1, dv2)
// with r the thread's row index (ly = ty + r * BY, lx = tx).  Every
// thread of the block must call it: it synchronises once, between the
// fluxes and the tendencies.
template <bool Fast_, class Mt, class Epilogue>
__device__ __forceinline__ void swe_face_tile(
    const SweWindow& w, const Mt& mt, SweScratch& s, const float* fr,
    const float* __restrict__ xc, const float* __restrict__ xf,
    const Consts& k, int n, int hh, int j0, int i0, Epilogue epi) {
  constexpr bool table = std::is_same<Mt, SweBasis>::value;
  auto H = [&](int y, int x) { return w.h[y + 2][WOFF + x]; };
  auto V = [&](int c, int y, int x) { return w.v[c][y + 1][WOFF + x]; };

  // ---- covariant components and Bernoulli function on the band ---------
  for_region<FTY + 2, FTX + 2>([&](int ly, int lx) {
    const int j = j0 + ly - 1, i = i0 + lx - 1;
    float va = 0.0f, vb = 0.0f, bern = 0.0f;
    if (band_cell(n, j, i)) {
      const float v[3] = {V(0, ly - 1, lx - 1), V(1, ly - 1, lx - 1),
                          V(2, ly - 1, lx - 1)};
      if constexpr (Fast_) {
        float x, y;
        const Fast F = TilePoints{mt}.band(ly, lx, x, y);
        fast_covariant(fr, v, x, y, F, va, vb);
      } else {
        const float x = xc[i + hh], y = xc[j + hh];
        const Prelude p = prelude(x, y);
        float rhat[3], e_a[3], e_b[3];
        basis_rhat(fr, x, y, p, rhat);
        basis_e(fr, rhat, p, k, e_a, e_b);
        va = (v[0] * e_a[0] + v[1] * e_a[1]) + v[2] * e_a[2];
        vb = (v[0] * e_b[0] + v[1] * e_b[1]) + v[2] * e_b[2];
      }
      const float ke = 0.5f * ((v[0] * v[0] + v[1] * v[1]) + v[2] * v[2]);
      bern = k.gravity * (H(ly - 1, lx - 1) + w.b[ly][lx]) + ke;
    }
    s.va[ly][lx] = va;
    s.vb[ly][lx] = vb;
    s.bern[ly][lx] = bern;
  });

  // ---- mass fluxes through the alpha-faces (i) and beta-faces (j) -----
  for_region<FTY, FTX + 1>([&](int ly, int lf) {
    const int j = j0 + ly, i = i0 + lf;   // face i: cells i-1 | i
    float flux = 0.0f;
    if (j < n && i <= n) {
      float v[3];
      for (int c = 0; c < 3; ++c)
        v[c] = 0.5f * (V(c, ly, lf - 1) + V(c, ly, lf));
      float u, sg;
      if constexpr (Fast_) {
        float x, y, vea, veb;
        const Fast F = TilePoints{mt}.xface(ly, lf, x, y);
        fast_covariant(fr, v, x, y, F, vea, veb);
        u = F.inv_aa * vea + F.inv_ab * veb;
        sg = F.sqrtg;
      } else {
        face_velocity<true>(fr, v, xf[i + hh], xc[j + hh], k,
                            [&](const Metric& g) {
                              if constexpr (table) return mt.idet_x[ly][lf];
                              else return basis_inv_det(g);
                            },
                            u, sg);
      }
      flux = sg * cov::upwind_flux(u, H(ly, lf - 2), H(ly, lf - 1),
                                   H(ly, lf), H(ly, lf + 1));
    }
    s.fx[ly][lf] = flux;
  });
  for_region<FTY + 1, FTX>([&](int lf, int lx) {
    const int j = j0 + lf, i = i0 + lx;   // face j: cells j-1 | j
    float flux = 0.0f;
    if (j <= n && i < n) {
      float v[3];
      for (int c = 0; c < 3; ++c)
        v[c] = 0.5f * (V(c, lf - 1, lx) + V(c, lf, lx));
      float u, sg;
      if constexpr (Fast_) {
        float x, y, vea, veb;
        const Fast F = TilePoints{mt}.yface(lf, lx, x, y);
        fast_covariant(fr, v, x, y, F, vea, veb);
        u = F.inv_ab * vea + F.inv_bb * veb;
        sg = F.sqrtg;
      } else {
        face_velocity<false>(fr, v, xc[i + hh], xf[j + hh], k,
                             [&](const Metric& g) {
                               if constexpr (table) return mt.idet_y[lf][lx];
                               else return basis_inv_det(g);
                             },
                             u, sg);
      }
      flux = sg * cov::upwind_flux(u, H(lf - 2, lx), H(lf - 1, lx),
                                   H(lf, lx), H(lf + 1, lx));
    }
    s.fy[lf][lx] = flux;
  });
  __syncthreads();

  // ---- tendencies -------------------------------------------------------
  const int lx = cov::tid_x();
#pragma unroll
  for (int r = 0; r < FTY / cov::BY; ++r) {
    const int ly = cov::tid_y() + r * cov::BY;
    const int j = j0 + ly, i = i0 + lx;
    if (j >= n || i >= n) continue;
    const float div = (s.fx[ly][lx + 1] - s.fx[ly][lx])
                    + (s.fy[ly + 1][lx] - s.fy[ly][lx]);
    const float dvb_da = (s.vb[ly + 1][lx + 2] - s.vb[ly + 1][lx]) * k.inv2d;
    const float dva_db = (s.va[ly + 2][lx + 1] - s.va[ly][lx + 1]) * k.inv2d;
    const float dpa = (s.bern[ly + 1][lx + 2] - s.bern[ly + 1][lx])
                    * k.inv2d;
    const float dpb = (s.bern[ly + 2][lx + 1] - s.bern[ly][lx + 1])
                    * k.inv2d;
    float dh, rk[3], grad[3], zeta;
    if constexpr (Fast_) {
      float x, y;
      const Fast F = TilePoints{mt}.band(ly + 1, lx + 1, x, y);
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
      const float x = xc[i + hh], y = xc[j + hh];
      const Prelude p = prelude(x, y);
      float e_a[3], e_b[3], a_a[3], a_b[3];
      basis_rhat(fr, x, y, p, rk);
      basis_e(fr, rk, p, k, e_a, e_b);
      const Metric g = basis_g(x, y, p, k);
      float inv_det, inv_sg;
      if constexpr (table) {
        inv_det = mt.idet_c[ly][lx];
        inv_sg = mt.isg_c[ly][lx];
      } else {
        inv_det = basis_inv_det(g);
        inv_sg = 1.0f / basis_sqrtg(p, k);
      }
      basis_a(e_a, e_b, g, inv_det, a_a, a_b);
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
    epi(r, ly, lx, j, i, dh, dv[0] - rk[0] * dvdotk, dv[1] - rk[1] * dvdotk,
        dv[2] - rk[2] * dvdotk);
  }
}

}  // namespace swe
