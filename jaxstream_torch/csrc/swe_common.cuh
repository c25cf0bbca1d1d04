// Device code shared by the Cartesian shallow-water kernels of
// jaxstream_torch (swe_rhs.cu, swe_stage.cu, swe_stage_inkernel.cu, through
// swe_faces.cuh): the two metric cores of jaxstream_torch.ops.cuda.swe_rhs
// (the general basis _basis of rhs_core, the orthonormal-frame closed
// forms _fast_frame of rhs_core_fast) and the general core's face
// velocity.  Every function reproduces the plain PyTorch version's
// operations in its order; the kernels are built with -fmad=false, so
// each multiply and add rounds separately, as PyTorch's do.

#pragma once

#include <cuda_runtime.h>

namespace swe {

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

// The closed-form 2x2 metric at (X, Y) = (x, y).
struct Metric {
  float gaa, gbb, gab;
};

__device__ __forceinline__ Metric basis_g(float x, float y, const Prelude& p,
                                          const Consts& k) {
  const float inv_rho4 = p.inv_rho2 * p.inv_rho2;
  const float gcom = ((k.R2 * p.dxda) * p.dydb) * inv_rho4;
  return Metric{gcom * p.dxda, gcom * p.dydb, ((-gcom) * x) * y};
}

// 1 / det g: the IEEE division of basis_a.
__device__ __forceinline__ float basis_inv_det(const Metric& g) {
  return 1.0f / (g.gaa * g.gbb - g.gab * g.gab);
}

// The dual basis a_a, a_b from e_a, e_b through the metric g and its
// inverse determinant inv_det (basis_inv_det(g)).
__device__ __forceinline__ void basis_a(const float* e_a, const float* e_b,
                                        const Metric& g, float inv_det,
                                        float* a_a, float* a_b) {
  const float inv_aa = g.gbb * inv_det;
  const float inv_ab = (-g.gab) * inv_det;
  const float inv_bb = g.gaa * inv_det;
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

// ---- the general core at a face -----------------------------------------

// sqrtg * u^alpha at the x-face (X, Y) = (x, y) of the face-averaged
// Cartesian velocity v through the general basis: u^alpha = v . a_a and
// the face's sqrtg factor.  Along beta (Alpha = false) the same at a
// y-face.  det(g) gives the metric's inverse determinant: basis_inv_det
// of g, or the same float from a per-tile table.
template <bool Alpha, class Det>
__device__ __forceinline__ void face_velocity(const float* fr, const float* v,
                                              float x, float y,
                                              const Consts& k, Det det,
                                              float& u, float& sg) {
  const Prelude p = prelude(x, y);
  float rhat[3], e_a[3], e_b[3], a[3];
  basis_rhat(fr, x, y, p, rhat);
  basis_e(fr, rhat, p, k, e_a, e_b);
  const Metric g = basis_g(x, y, p, k);
  basis_a(e_a, e_b, g, det(g), Alpha ? a : nullptr, Alpha ? nullptr : a);
  u = (v[0] * a[0] + v[1] * a[1]) + v[2] * a[2];
  sg = basis_sqrtg(p, k);
}

}  // namespace swe
