// Device code shared by the covariant shallow-water kernels of
// jaxstream_torch: the boundary strips, the face-state policies (PLR with
// each limiter, PPM) and the upwind flux, the RK combine, the closed-form
// metric terms (_fast_frame), the conservative Laplacian (lap_core) and
// the stage's constants and imposed edge normals.  Every function
// reproduces the plain PyTorch version's operations in its order; the
// kernels are built with -fmad=false, so each multiply and add rounds
// separately, as PyTorch's do.  Everything is __forceinline__: each
// kernel compiles to the code it would have with the functions written
// out in it.

#pragma once

#include <cuda_runtime.h>

#include "cov_half.cuh"

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

// ---- face states: one policy type per reconstruction ----------------------
//
// A policy R gives the apron R::A its stencil reads on each side of the
// cell row and R::states(q, qL, qR): the upwind states at the face between
// cells i-1 and i from q(k), the value of cell i+k (k = -A .. A-1).  The
// PLR policies take a slope (ops/reconstruct.py's LIMITERS); Ppm is
// ppm_face_states.  Each is the plain version's operations in its order.

// Monotonized-central slope, sign-free form (ops/reconstruct.py _slope_mc).
__device__ __forceinline__ float slope_mc(float dqm, float dqp) {
  const float a = 0.5f * (dqm + dqp);
  const float b = 2.0f * dqm;
  const float c = 2.0f * dqp;
  return fmaxf(fminf(fminf(a, b), c), 0.0f)
       + fminf(fmaxf(fmaxf(a, b), c), 0.0f);
}

// The unlimited centered slope (_slope_none).
struct SlopeNone {
  static __device__ __forceinline__ float f(float dqm, float dqp) {
    return 0.5f * (dqm + dqp);
  }
};

// minmod, sign-free (_slope_minmod).
struct SlopeMinmod {
  static __device__ __forceinline__ float f(float dqm, float dqp) {
    return fmaxf(fminf(dqm, dqp), 0.0f) + fminf(fmaxf(dqm, dqp), 0.0f);
  }
};

struct SlopeMc {
  static __device__ __forceinline__ float f(float dqm, float dqp) {
    return slope_mc(dqm, dqp);
  }
};

// torch.sign: 1, -1, or 0 for either zero.
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// The sign() form of MC (_slope_mc_sign).
struct SlopeMcSign {
  static __device__ __forceinline__ float f(float dqm, float dqp) {
    const float sgn = 0.5f * (sign_of(dqm) + sign_of(dqp));
    const float mag = fminf(0.5f * fabsf(dqm + dqp),
                            2.0f * fminf(fabsf(dqm), fabsf(dqp)));
    return sgn * mag;
  }
};

// van Leer (_slope_vanleer): the plain version's 1e-300 is 0 in float32,
// added all the same (it turns a -0 sum into +0); IEEE division (the
// kernels are built without --use_fast_math); the select evaluates only
// the branch it takes.
struct SlopeVanleer {
  static __device__ __forceinline__ float f(float dqm, float dqp) {
    const float prod = dqm * dqp;
    return prod > 0.0f ? (2.0f * prod) / ((dqm + dqp) + 0.0f) : 0.0f;
  }
};

// PLR with slope L (plr_face_states): a 2-deep apron.
template <class L>
struct Plr {
  static constexpr int A = 2;

  // From the four cells i-2 (qm), i-1 (q0), i (q1), i+1 (qp).
  static __device__ __forceinline__ void face(float qm, float q0, float q1,
                                              float qp, float& qL,
                                              float& qR) {
    qL = q0 + 0.5f * L::f(q0 - qm, q1 - q0);
    qR = q1 - 0.5f * L::f(q1 - q0, qp - q1);
  }

  template <class Q>
  static __device__ __forceinline__ void states(Q q, float& qL, float& qR) {
    face(q(-2), q(-1), q(0), q(1), qL, qR);
  }
};

using PlrMc = Plr<SlopeMc>;

// ---- the bf16 stage policy's PLR (pick_recon_precision) -----------------
// The cell differences are formed in float32 and rounded to bfloat16, the
// limiter algebra runs in bfloat16 (each operation's float32 result
// rounded, bf16_round, as PyTorch computes a bfloat16 op), and the
// half-slope, rounded, is widened and added to the float32 cell value.
// min, max, abs, sign and the selects are exact in any format.

struct SlopeNoneLo {
  static __device__ __forceinline__ float f(float dqm, float dqp) {
    return bf16_round(0.5f * bf16_round(dqm + dqp));
  }
};

struct SlopeMinmodLo {
  static __device__ __forceinline__ float f(float dqm, float dqp) {
    return bf16_round(fmaxf(fminf(dqm, dqp), 0.0f)
                      + fminf(fmaxf(dqm, dqp), 0.0f));
  }
};

struct SlopeMcLo {
  static __device__ __forceinline__ float f(float dqm, float dqp) {
    const float a = bf16_round(0.5f * bf16_round(dqm + dqp));
    const float b = bf16_round(2.0f * dqm);
    const float c = bf16_round(2.0f * dqp);
    return bf16_round(fmaxf(fminf(fminf(a, b), c), 0.0f)
                      + fminf(fmaxf(fmaxf(a, b), c), 0.0f));
  }
};

struct SlopeMcSignLo {
  static __device__ __forceinline__ float f(float dqm, float dqp) {
    const float sgn = bf16_round(0.5f * bf16_round(sign_of(dqm)
                                                   + sign_of(dqp)));
    const float mag = fminf(
        bf16_round(0.5f * fabsf(bf16_round(dqm + dqp))),
        bf16_round(2.0f * fminf(fabsf(dqm), fabsf(dqp))));
    return bf16_round(sgn * mag);
  }
};

struct SlopeVanleerLo {
  static __device__ __forceinline__ float f(float dqm, float dqp) {
    const float prod = bf16_round(dqm * dqp);
    return prod > 0.0f
               ? bf16_round(bf16_round(2.0f * prod)
                            / bf16_round(bf16_round(dqm + dqp) + 0.0f))
               : 0.0f;
  }
};

// PLR with the bfloat16 slope L (one of the *Lo slopes above).  lo: the
// stage's flux face-average velocities are bfloat16 too (stage_face_tile
// reads it through LoOf).
template <class L>
struct PlrLo {
  static constexpr int A = 2;
  static constexpr bool lo = true;

  static __device__ __forceinline__ void face(float qm, float q0, float q1,
                                              float qp, float& qL,
                                              float& qR) {
    qL = q0 + bf16_round(0.5f * L::f(bf16_round(q0 - qm),
                                     bf16_round(q1 - q0)));
    qR = q1 - bf16_round(0.5f * L::f(bf16_round(q1 - q0),
                                     bf16_round(qp - q1)));
  }

  template <class Q>
  static __device__ __forceinline__ void states(Q q, float& qL, float& qR) {
    face(q(-2), q(-1), q(0), q(1), qL, qR);
  }
};

// PPM (ppm_face_states): a 3-deep apron.  Face i's states are the right
// edge of cell i-1's parabola and the left edge of cell i's; the three
// edge values they need are computed here for this face (a neighbouring
// face computes the same floats from the same cells).
struct Ppm {
  static constexpr int A = 3;

  // The edge value at the face between cells i+k-1 and i+k:
  // 7/12 (q_{k-1} + q_k) - 1/12 (q_{k-2} + q_{k+1}), the constants the
  // float32 roundings of 7/12 and 1/12.
  template <class Q>
  static __device__ __forceinline__ float edge(Q q, int k) {
    return 0x1.2aaaaap-1f * (q(k - 1) + q(k))
         - 0x1.555556p-4f * (q(k - 2) + q(k + 1));
  }

  // CW84 eq. 1.10 on the parabola of the cell with mean qc and edges
  // ql, qr: flattened at a local extremum, then the overshoots clipped
  // (the second clip reads the first's result).
  static __device__ __forceinline__ void limit(float qc, float& ql,
                                               float& qr) {
    const bool extremum = (qr - qc) * (qc - ql) <= 0.0f;
    ql = extremum ? qc : ql;
    qr = extremum ? qc : qr;
    const float dq = qr - ql;
    const float q6 = 6.0f * (qc - 0.5f * (ql + qr));
    ql = dq * q6 > dq * dq ? 3.0f * qc - 2.0f * qr : ql;
    qr = -(dq * dq) > dq * q6 ? 3.0f * qc - 2.0f * ql : qr;
  }

  template <class Q>
  static __device__ __forceinline__ void states(Q q, float& qL, float& qR) {
    const float em = edge(q, -1), e0 = edge(q, 0), ep = edge(q, 1);
    float l0 = em, r0 = e0, l1 = e0, r1 = ep;
    limit(q(-1), l0, r0);   // cell i-1
    limit(q(0), l1, r1);    // cell i
    qL = r0;
    qR = l1;
  }
};

// Upwind flux through the face between cells i-1 and i, its states from
// policy R over the cells q(k) = cell i+k; U is the sqrtg-folded normal
// velocity.
template <class R, class Q>
__device__ __forceinline__ float upwind_flux(float U, Q q) {
  float qL, qR;
  R::states(q, qL, qR);
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
