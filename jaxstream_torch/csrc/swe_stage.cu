// One fused SSPRK3 stage of the Cartesian shallow-water equations over
// extended, ghost-filled state: the Hopper (sm_90a) kernel of
// jaxstream_torch's ShallowWater.make_fused_step(dt,
// in_kernel_exchange=False).
//
// Replaces the Pallas TPU kernel make_swe_stage_pallas
// (jaxstream/ops/pallas/swe_step.py:64, pallas_call at :147).  The plain
// PyTorch version of the same function is
// jaxstream_torch.ops.cuda.swe_step.swe_stage_reference; the kernel
// reproduces its operations in its order (built with -fmad=false, so
// every multiply and add rounds separately, as PyTorch's do).
//
// What it computes, per face f:
//   tend     the Cartesian RHS L(yc) of the input blocks hc (6, m, m) and
//            vc (3, 6, m, m), whose ghosts (corners averaged) the
//            caller's exchanger filled: rhs_core_fast when fast != 0,
//            rhs_core otherwise (a compile-time switch, both built).
//   out      the whole (m, m) block is a*y0 + b*yc (stage 1, with_y0 ==
//            0: yc itself); its interior becomes that value +
//            b*dt*tend.  Every cell is written once.
//
// Design.  As swe_rhs.cu: one 32 x 16 tile of one face per block, a grid
// of (ceil(n/32), ceil(n/16), 6) independent blocks.  A block stages h
// with a 2-deep apron and the velocity with a 1-deep apron from the
// input blocks, writes the ghost ring cells whose nearest interior cell
// is in its tile (edge tiles only), then runs swe_common.cuh's swe_tile
// and combines in its epilogue.
//
// Bound.  Stage 1 reads hc, vc and b (5 x 6 m^2 floats) and writes h, v
// (4 x 6 m^2): at C384 (m = 388) 32.52 MB -> 9.71 us at 3.35 TB/s.
// Stages 2-3 also read h0, v0: 46.97 MB -> 14.02 us.  The float32
// arithmetic (~200 flops per cell with the fast core) is ~2 us at
// 67 TFLOP/s: bound by memory.  This first design is simple and right;
// TMA / cp.async staging is for later.

#include "swe_common.cuh"

namespace {

using namespace swe;

constexpr int AP = 2;      // h apron: PLR reads two cells past a face

struct Params {
  const float* h0;      // (6, m, m) stage base, read only if with_y0
  const float* v0;      // (3, 6, m, m)
  const float* hc;      // (6, m, m) current stage, ghosts filled
  const float* vc;      // (3, 6, m, m)
  const float* b;       // (6, m, m) orography, ghosts filled
  const float* xc;      // (m,) tan of the cell-center coordinates
  const float* xf;      // (m,) tan of the left-face coordinates
  const float* frames;  // (6, 3, 3) face frames c0, cx, cy
  float* ho;            // (6, m, m)
  float* vo;            // (3, 6, m, m)
  int n, halo, with_y0;
  Consts k;
  float a, bcoef, g_dt;
};

__device__ __forceinline__ float frame_at(const float* __restrict__ q,
                                          int n, int hh, int j, int i) {
  if (j < -hh || j >= n + hh || i < -hh || i >= n + hh) return 0.0f;
  return q[(j + hh) * (n + 2 * hh) + i + hh];
}

// At least 4 resident blocks per SM caps the kernel at 64 registers.
template <bool Fast_>
__global__ void __launch_bounds__(BX * BY, 4)
swe_stage_kernel(const Params p) {
  __shared__ float s_h[TY + 2 * AP][TX + 2 * AP];
  __shared__ float s_v[3][TY + 2][TX + 2];
  __shared__ float s_fr[9];
  __shared__ Scratch s;

  const int n = p.n, hh = p.halo, m = n + 2 * hh;
  const int f = blockIdx.z;
  const int i0 = blockIdx.x * TX, j0 = blockIdx.y * TY;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long mm = (long)m * m;
  // Field q: 0 = h, 1..3 = v components; offset of face f's block.
  auto off = [&](int q) { return (q == 0 ? f : (q - 1) * 6 + f) * mm; };

  // ---- 1. stage the tile with its aprons, and the face frame ----------
  for (int ly = ty; ly < TY + 2 * AP; ly += BY)
    for (int lx = tx; lx < TX + 2 * AP; lx += BX)
      s_h[ly][lx] = frame_at(p.hc + off(0), n, hh, j0 + ly - AP,
                             i0 + lx - AP);
  for (int ly = ty; ly < TY + 2; ly += BY)
    for (int lx = tx; lx < TX + 2; lx += BX)
      for (int c = 0; c < 3; ++c)
        s_v[c][ly][lx] = frame_at(p.vc + off(1 + c), n, hh, j0 + ly - 1,
                                  i0 + lx - 1);
  if (ty == 0 && tx < 9) s_fr[tx] = p.frames[9 * f + tx];

  // ---- 2. the ghost ring cells of this tile: a*y0 + b*yc ---------------
  // Ring cell (j, i) belongs to the tile holding its nearest interior
  // cell; interior tiles own none.
  const int jlo = j0 == 0 ? -hh : j0;
  const int jhi = j0 + TY >= n ? n + hh : j0 + TY;
  const int ilo = i0 == 0 ? -hh : i0;
  const int ihi = i0 + TX >= n ? n + hh : i0 + TX;
  if (jlo < 0 || jhi > n || ilo < 0 || ihi > n)
    for (int j = jlo + ty; j < jhi; j += BY)
      for (int i = ilo + tx; i < ihi; i += BX) {
        if (j >= 0 && j < n && i >= 0 && i < n) continue;
        const long c = (long)(j + hh) * m + i + hh;
        for (int q = 0; q < 4; ++q) {
          const long cq = off(q) + c;
          const float yc = (q == 0 ? p.hc : p.vc)[cq];
          const float v =
              p.with_y0 ? p.a * (q == 0 ? p.h0 : p.v0)[cq] + p.bcoef * yc
                        : yc;
          (q == 0 ? p.ho : p.vo)[cq] = v;
        }
      }
  __syncthreads();

  // ---- 3. tendencies, RK combine, interior stores -----------------------
  swe_tile<Fast_>(
      &s_h[0][0], &s_v[0][0][0], s, s_fr, p.b + off(0), p.xc, p.xf, p.k, n,
      hh, j0, i0,
      [=](int ly, int lx, int j, int i, float dh, float dv0, float dv1,
          float dv2) {
        const long c = (long)(j + hh) * m + i + hh;
        const float tend[4] = {dh, dv0, dv1, dv2};
        for (int q = 0; q < 4; ++q) {
          const long cq = off(q) + c;
          const float yc = q == 0 ? s_h[ly + AP][lx + AP]
                                  : s_v[q - 1][ly + 1][lx + 1];
          const float y0 = p.with_y0 ? (q == 0 ? p.h0 : p.v0)[cq] : 0.0f;
          (q == 0 ? p.ho : p.vo)[cq] =
              cov::combine(p.with_y0, p.a, p.bcoef, p.g_dt, y0, yc,
                           tend[q]);
        }
      });
}

}  // namespace

// Launches one stage on `stream`; returns cudaGetLastError() (0 = ok).
// with_y0 == 0: yc + g_dt*L (stage 1; h0/v0 not read); with_y0 != 0:
// (a*y0 + b*yc) + g_dt*L.  fast != 0 selects rhs_core_fast.  All tensors
// float32, contiguous, in the layouts of Params.
extern "C" int swe_stage_f32(
    const float* h0, const float* v0, const float* hc, const float* vc,
    const float* b_ext, const float* xc, const float* xf,
    const float* frames, float* ho, float* vo, int n, int halo, int with_y0,
    int fast, float R, float R2, float gravity, float two_omega,
    float inv2d, float inv_d, float a, float b, float g_dt, void* stream) {
  Params p{h0, v0, hc, vc, b_ext, xc, xf, frames, ho, vo, n, halo, with_y0,
           Consts{R, R2, gravity, two_omega, inv2d, inv_d}, a, b, g_dt};
  const dim3 grid((n + TX - 1) / TX, (n + TY - 1) / TY, 6);
  const dim3 block(BX, BY);
  auto kern = fast ? swe_stage_kernel<true> : swe_stage_kernel<false>;
  kern<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
