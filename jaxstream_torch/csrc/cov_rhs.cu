// The covariant shallow-water right-hand side of ghost-filled extended
// faces: the Hopper (sm_90a) kernel of jaxstream_torch's classic path
// under backend='pallas'.
//
// Replaces the Pallas TPU kernel make_cov_rhs_pallas
// (jaxstream/ops/pallas/swe_cov.py:429, pallas_call at :508).  The plain
// PyTorch version of the same function is
// jaxstream_torch.ops.cuda.swe_cov.cov_rhs_reference; the kernel
// reproduces its operations in its order (built with -fmad=false, so
// every multiply and add rounds separately, as PyTorch's do).
//
// What it computes, per face f < nf and interior cell (j, i): the
// covariant RHS (rhs_core_cov, sym_prescaled=False) of the extended
// frames h_ext (nf, m, m), u_ext (2, nf, m, m), whose ghosts the
// caller's halo exchangers filled, with the orography b_ext (nf, m, m).
// The symmetrized edge normals sym_sn (nf, 2, n) / sym_we (nf, n, 2) are
// multiplied by the edge sqrtg of the closed-form frame and imposed on
// the boundary fluxes.  Out: the tendencies dh (nf, n, n) and du_a, du_b
// (2, nf, n, n); the RK combine is the stepper's.
//
// Design.  As cov_stage.cu: one 32 x 16 tile of one face per block, a
// grid of (ceil(n/32), ceil(n/16), nf) independent blocks, no atomics,
// bitwise reproducible.  A block stages its tile of h with a 2-deep
// apron and of u_a, u_b with a 1-deep apron in shared memory straight
// from the extended frames (halo >= 2, so every apron cell lies in the
// m x m block); the apron's diagonal cells come from the frames' ghost
// corners as they are, which no kept output reads.  cov_common.cuh's
// advective_tile then computes the fluxes, the Bernoulli band and the
// tendencies.
//
// Bound.  It reads h_ext, u_a, u_b and b_ext (4 x nf m^2 floats) and the
// sym rows (4 nf n), and writes 3 x nf n^2: at C384 (nf = 6, m = 388)
// that is 25.11 MB -> 7.49 us at 3.35 TB/s, against ~1.8 us of float32
// arithmetic at 67 TFLOP/s (~137 flops per cell): bound by memory.  This
// first design is simple and right; it reads the aprons again from
// memory in each neighbouring block and has no TMA or cp.async staging.

#include "cov_common.cuh"

namespace {

using namespace cov;

constexpr int AP = 2;      // h apron: PLR reads two cells past a face

struct Params {
  const float* fz;      // (nf, 1, 3) face-frame z components (c0, cx, cy)
  const float* h;       // (nf, m, m) ghost-filled
  const float* u;       // (2, nf, m, m)
  const float* b;       // (nf, m, m) orography
  const float* sym_sn;  // (nf, 2, n) S, N edge normals (not prescaled)
  const float* sym_we;  // (nf, n, 2) W, E edge normals
  const float* xc;      // (m,) tan of the cell-center coordinates
  const float* xf;      // (m,) tan of the left-face coordinates
  float* dh;            // (nf, n, n)
  float* du;            // (2, nf, n, n)
  int nf, n, halo;
  float R2, gravity, two_omega, inv2d, inv_d;
};

// Extended frame q (m x m) at face-local (j, i); 0 past the frame (the
// ragged last tiles' aprons, which feed no kept output).
__device__ __forceinline__ float frame_at(const float* __restrict__ q,
                                          int n, int hh, int j, int i) {
  if (j < -hh || j >= n + hh || i < -hh || i >= n + hh) return 0.0f;
  return q[(j + hh) * (n + 2 * hh) + i + hh];
}

__global__ void __launch_bounds__(BX * BY, 4)
cov_rhs_kernel(const Params p) {
  __shared__ float s_h[TY + 2 * AP][TX + 2 * AP];
  __shared__ float s_ua[TY + 2][TX + 2];
  __shared__ float s_ub[TY + 2][TX + 2];
  __shared__ AdvScratch s_adv;

  const int n = p.n, hh = p.halo, m = n + 2 * hh, nf = p.nf;
  const int f = blockIdx.z;
  const int i0 = blockIdx.x * TX, j0 = blockIdx.y * TY;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long mm = (long)m * m, nn = (long)n * n;
  const float* hf = p.h + f * mm;
  const float* ua = p.u + f * mm;
  const float* ub = p.u + (nf + f) * mm;

  // ---- 1. stage the tile with its aprons from the extended frames -----
  for (int ly = ty; ly < TY + 2 * AP; ly += BY)
    for (int lx = tx; lx < TX + 2 * AP; lx += BX)
      s_h[ly][lx] = frame_at(hf, n, hh, j0 + ly - AP, i0 + lx - AP);
  for (int ly = ty; ly < TY + 2; ly += BY)
    for (int lx = tx; lx < TX + 2; lx += BX) {
      const int j = j0 + ly - 1, i = i0 + lx - 1;
      s_ua[ly][lx] = frame_at(ua, n, hh, j, i);
      s_ub[ly][lx] = frame_at(ub, n, hh, j, i);
    }
  __syncthreads();

  // ---- 2. tendencies ----------------------------------------------------
  const float* sn = p.sym_sn + (long)f * 2 * n;
  const float* we = p.sym_we + (long)f * n * 2;
  const SymRows sym{sn, sn + n, we, we + 1, 2};
  const StageConsts k{p.R2, p.gravity, p.two_omega, p.inv2d, p.inv_d};
  advective_tile<false, TX + 2 * AP, TX + 2>(
      &s_h[0][0], &s_ua[0][0], &s_ub[0][0], s_adv, sym, p.b + f * mm, p.xc,
      p.xf, p.fz + 3 * f, k, n, hh, j0, i0,
      [=](int, int, int j, int i, float dh, float dua, float dub) {
        const long c = f * nn + (long)j * n + i;
        p.dh[c] = dh;
        p.du[c] = dua;
        p.du[nf * nn + c] = dub;
      });
}

}  // namespace

// Launches the RHS of nf faces on `stream`; returns cudaGetLastError()
// (0 = ok).  All tensors float32, contiguous, in the layouts of Params.
extern "C" int cov_rhs_f32(
    const float* fz, const float* h_ext, const float* u_ext,
    const float* b_ext, const float* sym_sn, const float* sym_we,
    const float* xc, const float* xf, float* dh, float* du,
    int nf, int n, int halo,
    float R2, float gravity, float two_omega, float inv2d, float inv_d,
    void* stream) {
  Params p{fz, h_ext, u_ext, b_ext, sym_sn, sym_we, xc, xf, dh, du,
           nf, n, halo, R2, gravity, two_omega, inv2d, inv_d};
  const dim3 grid((n + TX - 1) / TX, (n + TY - 1) / TY, nf);
  const dim3 block(BX, BY);
  cov_rhs_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
