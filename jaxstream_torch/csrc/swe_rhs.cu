// The Cartesian shallow-water right-hand side of ghost-filled extended
// faces: the Hopper (sm_90a) kernel of jaxstream_torch's classic
// ShallowWater path under backend='pallas'.
//
// Replaces the Pallas TPU kernel make_swe_rhs_pallas
// (jaxstream/ops/pallas/swe_rhs.py:373, pallas_call at :434).  The plain
// PyTorch version of the same function is
// jaxstream_torch.ops.cuda.swe_rhs.swe_rhs_reference (rhs_core); the
// kernel reproduces its operations in its order (built with -fmad=false,
// so every multiply and add rounds separately, as PyTorch's do).
//
// What it computes, per face f and interior cell (j, i): the Cartesian
// RHS (rhs_core, the general basis _basis) of the extended frames h_ext
// (6, m, m) and v_ext (3, 6, m, m), whose ghosts the caller's halo
// exchangers filled, with the orography b_ext (6, m, m): the upwind
// PLR-MC mass flux through sqrtg a^i at the faces, the vorticity from the
// covariant components v . e_i on the band, the Bernoulli gradient, the
// Coriolis term and the tangent projection.  Out: dh (6, n, n) and dv
// (3, 6, n, n); the RK combine is the stepper's.
//
// Design.  As cov_rhs.cu: one 32 x 16 tile of one face per block, a grid
// of (ceil(n/32), ceil(n/16), 6) independent blocks, no atomics, bitwise
// reproducible.  A block stages its tile of h with a 2-deep apron and of
// the three velocity components with a 1-deep apron in shared memory
// straight from the extended frames (halo >= 2, so every apron cell lies
// in the m x m block), and the face frame; swe_common.cuh's swe_tile
// computes the band, the fluxes and the tendencies.  The general basis
// (an inverse 2x2 metric per evaluation, four evaluations per cell) is
// what the JAX kernel computes; the stage kernels use the fast core.
//
// Bound.  It reads h, v (3 components) and b (5 x 6 m^2 floats) and
// writes 4 x 6 n^2: at C384 (m = 388) 32.22 MB -> 9.62 us at 3.35 TB/s.
// The float32 arithmetic is a few hundred flops per cell (~5 us at
// 67 TFLOP/s): bound by memory.  This first design is simple and right;
// it reads the aprons again in each neighbouring block and has no TMA or
// cp.async staging.

#include "swe_common.cuh"

namespace {

using namespace swe;

constexpr int AP = 2;      // h apron: PLR reads two cells past a face

struct Params {
  const float* frames;  // (6, 3, 3) face frames c0, cx, cy
  const float* h;       // (6, m, m) ghost-filled
  const float* v;       // (3, 6, m, m)
  const float* b;       // (6, m, m) orography
  const float* xc;      // (m,) tan of the cell-center coordinates
  const float* xf;      // (m,) tan of the left-face coordinates
  float* dh;            // (6, n, n)
  float* dv;            // (3, 6, n, n)
  int n, halo;
  Consts k;
};

// Extended frame q (m x m) at face-local (j, i); 0 past the frame (the
// ragged last tiles' aprons, which feed no kept output).
__device__ __forceinline__ float frame_at(const float* __restrict__ q,
                                          int n, int hh, int j, int i) {
  if (j < -hh || j >= n + hh || i < -hh || i >= n + hh) return 0.0f;
  return q[(j + hh) * (n + 2 * hh) + i + hh];
}

__global__ void __launch_bounds__(BX * BY, 4)
swe_rhs_kernel(const Params p) {
  __shared__ float s_h[TY + 2 * AP][TX + 2 * AP];
  __shared__ float s_v[3][TY + 2][TX + 2];
  __shared__ float s_fr[9];
  __shared__ Scratch s;

  const int n = p.n, hh = p.halo, m = n + 2 * hh;
  const int f = blockIdx.z;
  const int i0 = blockIdx.x * TX, j0 = blockIdx.y * TY;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long mm = (long)m * m, nn = (long)n * n;

  // ---- 1. stage the tile with its aprons, and the face frame ----------
  for (int ly = ty; ly < TY + 2 * AP; ly += BY)
    for (int lx = tx; lx < TX + 2 * AP; lx += BX)
      s_h[ly][lx] = frame_at(p.h + f * mm, n, hh, j0 + ly - AP,
                             i0 + lx - AP);
  for (int ly = ty; ly < TY + 2; ly += BY)
    for (int lx = tx; lx < TX + 2; lx += BX)
      for (int c = 0; c < 3; ++c)
        s_v[c][ly][lx] = frame_at(p.v + (c * 6 + f) * mm, n, hh,
                                  j0 + ly - 1, i0 + lx - 1);
  if (ty == 0 && tx < 9) s_fr[tx] = p.frames[9 * f + tx];
  __syncthreads();

  // ---- 2. tendencies ----------------------------------------------------
  swe_tile<false>(
      &s_h[0][0], &s_v[0][0][0], s, s_fr, p.b + f * mm, p.xc, p.xf, p.k, n,
      hh, j0, i0,
      [=](int, int, int j, int i, float dh, float dv0, float dv1,
          float dv2) {
        const long c = f * nn + (long)j * n + i;
        p.dh[c] = dh;
        p.dv[c] = dv0;
        p.dv[6 * nn + c] = dv1;
        p.dv[12 * nn + c] = dv2;
      });
}

}  // namespace

// Launches the RHS on `stream`; returns cudaGetLastError() (0 = ok).  All
// tensors float32, contiguous, in the layouts of Params.
extern "C" int swe_rhs_f32(
    const float* frames, const float* h_ext, const float* v_ext,
    const float* b_ext, const float* xc, const float* xf, float* dh,
    float* dv, int n, int halo, float R, float R2, float gravity,
    float two_omega, float inv2d, float inv_d, void* stream) {
  Params p{frames, h_ext, v_ext, b_ext, xc, xf, dh, dv, n, halo,
           Consts{R, R2, gravity, two_omega, inv2d, inv_d}};
  const dim3 grid((n + TX - 1) / TX, (n + TY - 1) / TY, 6);
  const dim3 block(BX, BY);
  swe_rhs_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
