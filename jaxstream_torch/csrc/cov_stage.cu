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
// differenced.
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

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;     // tile width along alpha (i)
constexpr int TY = 16;     // tile height along beta (j)
constexpr int BX = 32;     // threads along i
constexpr int BY = 8;      // threads along j
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

// Value of field fi at interior coordinates (j, i) of the face whose
// interior is q and whose routed ghosts are gsn/gwe (already offset to
// the face).  Ghost corners and cells past the ghost ring are zero: no
// kept output reads them.
__device__ __forceinline__ float fetch(const float* __restrict__ q,
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

__device__ __forceinline__ float combine(int with_y0, float a, float b,
                                         float g_dt, float y0, float yc,
                                         float tend) {
  if (with_y0) return (a * y0 + b * yc) + g_dt * tend;
  return yc + g_dt * tend;
}

// At least 4 resident blocks per SM caps the kernel at 64 registers.
// Left to itself nvcc took 66, which allows only 3 blocks of 256 threads
// per SM, and the stage ran ~18% slower on the H100.
__global__ void __launch_bounds__(BX * BY, 4)
cov_stage_kernel(const Params p) {
  __shared__ float s_h[TY + 2 * AP][TX + 2 * AP];
  __shared__ float s_ua[TY + 2][TX + 2];
  __shared__ float s_ub[TY + 2][TX + 2];
  __shared__ float s_bern[TY + 2][TX + 2];
  __shared__ float s_uca[TY][TX];
  __shared__ float s_ucb[TY][TX];
  __shared__ float s_fx[TY][TX + 1];
  __shared__ float s_fy[TY + 1][TX];

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
  const float* bf = p.b + (long)f * m * m;
  const float* xc = p.xc;
  const float* xf = p.xf;
  const float R2 = p.R2;

  // ---- 1. stage the tile with its aprons ------------------------------
  for (int ly = ty; ly < TY + 2 * AP; ly += BY)
    for (int lx = tx; lx < TX + 2 * AP; lx += BX)
      s_h[ly][lx] = fetch(hc, gsn, gwe, 0, n, hh, rw, j0 + ly - AP,
                          i0 + lx - AP);
  for (int ly = ty; ly < TY + 2; ly += BY)
    for (int lx = tx; lx < TX + 2; lx += BX) {
      const int j = j0 + ly - 1, i = i0 + lx - 1;
      s_ua[ly][lx] = fetch(ua, gsn, gwe, 1, n, hh, rw, j, i);
      s_ub[ly][lx] = fetch(ub, gsn, gwe, 2, n, hh, rw, j, i);
    }
  __syncthreads();

  // ---- 2a. Bernoulli function and contravariant u on the band ---------
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
        const float va = s_ua[ly][lx], vb = s_ub[ly][lx];
        const float uca = g_aa * va + g_ab * vb;
        const float ucb = g_ab * va + g_bb * vb;
        const float ke = 0.5f * (uca * va + ucb * vb);
        bern = p.gravity * (s_h[ly + 1][lx + 1] + bf[(j + hh) * m + i + hh])
             + ke;
        if (ly >= 1 && ly <= TY && lx >= 1 && lx <= TX) {
          s_uca[ly - 1][lx - 1] = uca;
          s_ucb[ly - 1][lx - 1] = ucb;
        }
      }
      s_bern[ly][lx] = bern;
    }

  // ---- 2b. mass fluxes through the alpha-faces (i) and beta-faces (j) -
  for (int ly = ty; ly < TY; ly += BY)
    for (int lf = tx; lf < TX + 1; lf += BX) {
      const int j = j0 + ly, i = i0 + lf;   // face i: cells i-1 | i
      float flux = 0.0f;
      if (j < n && i <= n) {
        float U;
        if (i == 0) {
          U = gwe[j * rw + 6 * hh];          // W seam, prescaled
        } else if (i == n) {
          U = gwe[j * rw + 6 * hh + 1];      // E seam, prescaled
        } else {
          const float x = xf[i + hh], y = xc[j + hh];
          const float dydb = 1.0f + y * y;
          const float rho2 = (1.0f + x * x) + y * y;
          const float inv_rho = rsqrtf(rho2);
          const float fg_aa = dydb * inv_rho;
          const float fg_ab = (x * y) * inv_rho;
          const float uba = 0.5f * (s_ua[ly + 1][lf] + s_ua[ly + 1][lf + 1]);
          const float ubb = 0.5f * (s_ub[ly + 1][lf] + s_ub[ly + 1][lf + 1]);
          U = fg_aa * uba + fg_ab * ubb;
        }
        flux = upwind_flux(U, s_h[ly + AP][lf], s_h[ly + AP][lf + 1],
                           s_h[ly + AP][lf + 2], s_h[ly + AP][lf + 3]);
      }
      s_fx[ly][lf] = flux;
    }
  for (int lf = ty; lf < TY + 1; lf += BY)
    for (int lx = tx; lx < TX; lx += BX) {
      const int j = j0 + lf, i = i0 + lx;   // face j: cells j-1 | j
      float flux = 0.0f;
      if (j <= n && i < n) {
        float U;
        if (j == 0) {
          U = gsn[(6 * hh) * n + i];         // S seam, prescaled
        } else if (j == n) {
          U = gsn[(6 * hh + 1) * n + i];     // N seam, prescaled
        } else {
          const float x = xc[i + hh], y = xf[j + hh];
          const float dxda = 1.0f + x * x;
          const float rho2 = dxda + y * y;
          const float inv_rho = rsqrtf(rho2);
          const float fg_ab = (x * y) * inv_rho;
          const float fg_bb = dxda * inv_rho;
          const float vba = 0.5f * (s_ua[lf][lx + 1] + s_ua[lf + 1][lx + 1]);
          const float vbb = 0.5f * (s_ub[lf][lx + 1] + s_ub[lf + 1][lx + 1]);
          U = fg_ab * vba + fg_bb * vbb;
        }
        flux = upwind_flux(U, s_h[lf][lx + AP], s_h[lf + 1][lx + AP],
                           s_h[lf + 2][lx + AP], s_h[lf + 3][lx + AP]);
      }
      s_fy[lf][lx] = flux;
    }
  __syncthreads();

  // ---- 3. tendencies, RK combine, state and strip stores --------------
  const int sw = 6 * hh;   // strip width
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

      const float dh = -((s_fx[ly][lx + 1] - s_fx[ly][lx])
                         + (s_fy[ly + 1][lx] - s_fy[ly][lx]))
                     * (inv_sqrtg * p.inv_d);
      const float dba = (s_bern[ly + 1][lx + 2] - s_bern[ly + 1][lx])
                      * p.inv2d;
      const float dbb = (s_bern[ly + 2][lx + 1] - s_bern[ly][lx + 1])
                      * p.inv2d;
      const float dub_da = (s_ub[ly + 1][lx + 2] - s_ub[ly + 1][lx])
                         * p.inv2d;
      const float dua_db = (s_ua[ly + 2][lx + 1] - s_ua[ly][lx + 1])
                         * p.inv2d;
      const float* fz = p.fz + 3 * f;
      const float rz = ((fz[0] + x * fz[1]) + y * fz[2]) * inv_rho;
      const float absv = (dub_da - dua_db) + (p.two_omega * rz) * sqrtg;
      const float dua = absv * s_ucb[ly][lx] - dba;
      const float dub = (-absv) * s_uca[ly][lx] - dbb;

      const long c = f * nn + (long)j * n + i;
      float y0h = 0.0f, y0a = 0.0f, y0b = 0.0f;
      if (p.with_y0) {
        y0h = p.h0[c];
        y0a = p.u0[c];
        y0b = p.u0[6 * nn + c];
      }
      const float vals[3] = {
          combine(p.with_y0, p.a, p.bcoef, p.g_dt, y0h, s_h[ly + AP][lx + AP], dh),
          combine(p.with_y0, p.a, p.bcoef, p.g_dt, y0a, s_ua[ly + 1][lx + 1], dua),
          combine(p.with_y0, p.a, p.bcoef, p.g_dt, y0b, s_ub[ly + 1][lx + 1], dub)};
      p.ho[c] = vals[0];
      p.uo[c] = vals[1];
      p.uo[6 * nn + c] = vals[2];

      // Boundary strips in pack_strips_cov_split's layout.
      float* ssn = p.ssn + (long)f * sw * n;
      float* swe = p.swe + (long)f * n * sw;
      for (int fi = 0; fi < 3; ++fi) {
        const int base = fi * 2 * hh;
        if (j < hh) ssn[(base + j) * n + i] = vals[fi];
        if (j >= n - hh) ssn[(base + hh + j - (n - hh)) * n + i] = vals[fi];
        if (i < hh) swe[(long)j * sw + base + i] = vals[fi];
        if (i >= n - hh) swe[(long)j * sw + base + hh + i - (n - hh)] = vals[fi];
      }
    }
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
