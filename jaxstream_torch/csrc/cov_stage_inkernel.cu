// One SSPRK3 stage of the covariant shallow-water equations over the
// extended carry, with the ghost fill inside the kernel: the Hopper
// (sm_90a) kernel of jaxstream_torch's compact=False stepper.
//
// Replaces the Pallas TPU kernel make_cov_stage_inkernel
// (jaxstream/ops/pallas/swe_cov.py:1106, pallas_call at :1243).  The
// plain PyTorch version of the same function is
// jaxstream_torch.ops.cuda.swe_cov.cov_stage_inkernel_reference; the
// kernel reproduces its operations in its order (built with
// -fmad=false, so every multiply and add rounds separately, as
// PyTorch's do).
//
// What it computes, per face f:
//   frame    each of h, u_a, u_b is its whole input block (6, m, m) with
//            the edge ghosts replaced by the routed blocks of ghosts
//            (6, 12h+4, n): field fi at rows fi*4h .. fi*4h+4h as S, N,
//            W^T, E^T (fill_ghosts, W/E arriving transposed).  The ghost
//            corners stay the input's.  Rows 12h .. 12h+3 are the
//            symmetrized edge normals S, N, W, E, not prescaled: the
//            kernel multiplies them by the closed-form edge sqrtg.
//   tend     the covariant RHS of the frames (rhs_core_cov), as
//            cov_stage.cu computes it.
//   out      the whole (m, m) block is val = a*y0 + b*frame (stage 1:
//            the frame); its interior becomes val + b*dt*tend.  So the
//            ghost ring holds a*y0 + b*(routed ghost) and the corners
//            a*y0 + b*(input corner), as the TPU kernel writes them;
//            every cell is written once.  The new packed strips (6, 12h,
//            n) are the interior's S rows, N rows, W and E columns
//            transposed (pack_strips_cov).
//
// Design.  As cov_stage.cu: one 32 x 16 tile of one face per block, a
// grid of (ceil(n/32), ceil(n/16), 6) independent blocks.  A block
// stages its tile of h with a 2-deep apron and of u_a, u_b with a 1-deep
// apron in shared memory, each cell from the frame as above, then runs
// cov_common.cuh's advective_tile with the un-prescaled sym rows.  The
// blocks on a face edge also write the ghost ring cells whose nearest
// interior cell is in their tile.  The W/E strip stores turn a face
// column into a strip row, so they are strided.
//
// Bound.  Stage 1 reads hc, u_a, u_b and b (4 x 6 m^2 floats) and the
// routed ghosts (6 (12h+4) n), and writes h, u_a, u_b (3 x 6 m^2) and
// the strips (6 x 12h n): at C384 (m = 388) 25.77 MB -> 7.69 us at
// 3.35 TB/s.  Stages 2-3 also read h0, u0: 36.61 MB -> 10.93 us.  The
// float32 arithmetic (~137 flops per cell) is ~1.8 us at 67 TFLOP/s:
// bound by memory.  The extended carry moves whole m x m blocks, more
// bytes than the compact stage's 7.56 / 10.73 us, which is why the JAX
// package's production path is the compact carry.  This first design is
// simple and right; TMA / cp.async staging and coalesced strip stores
// are for later.

#include "cov_common.cuh"

namespace {

using namespace cov;

constexpr int AP = 2;      // h apron: PLR reads two cells past a face

struct Params {
  const float* h0;   // (6, m, m) stage base, read only if with_y0
  const float* u0;   // (2, 6, m, m)
  const float* hc;   // (6, m, m) current stage
  const float* uc;   // (2, 6, m, m)
  const float* gi;   // (6, 12h+4, n) routed ghosts + sym rows
  const float* b;    // (6, m, m) orography, ghosts filled
  const float* xc;   // (m,) tan of the cell-center coordinates
  const float* xf;   // (m,) tan of the left-face coordinates
  const float* fz;   // (6, 3) face-frame z components (c0, cx, cy)
  float* ho;         // (6, m, m)
  float* uo;         // (2, 6, m, m)
  float* so;         // (6, 12h, n)
  int n, halo, with_y0;
  float R2, gravity, two_omega, inv2d, inv_d, a, bcoef, g_dt;
};

// The stage's frame of field fi at face-local (j, i): the input block q
// (m x m) with its edge ghosts from the face's routed ghosts gi (12h+4,
// n).  0 past the frame (the ragged last tiles' aprons, which feed no
// kept output).
__device__ __forceinline__ float frame_in(const float* __restrict__ q,
                                          const float* __restrict__ gi,
                                          int fi, int n, int hh, int j,
                                          int i) {
  if (j < -hh || j >= n + hh || i < -hh || i >= n + hh) return 0.0f;
  const bool jin = j >= 0 && j < n;
  const bool iin = i >= 0 && i < n;
  const int base = fi * 4 * hh;
  if (iin && !jin)
    return gi[(j < 0 ? base + j + hh : base + hh + j - n) * n + i];
  if (jin && !iin)
    return gi[(i < 0 ? base + 2 * hh + i + hh : base + 3 * hh + i - n) * n
              + j];
  return q[(j + hh) * (n + 2 * hh) + i + hh];
}

// Value v of field fi at interior cell (j, i) into the face's packed
// strips so (12h, n), pack_strips_cov's layout.
__device__ __forceinline__ void put_packed(float* so, int fi, int n, int hh,
                                           int j, int i, float v) {
  const int base = fi * 4 * hh;
  if (j < hh) so[(base + j) * n + i] = v;
  if (j >= n - hh) so[(base + hh + j - (n - hh)) * n + i] = v;
  if (i < hh) so[(base + 2 * hh + i) * n + j] = v;
  if (i >= n - hh) so[(base + 3 * hh + i - (n - hh)) * n + j] = v;
}

// At least 4 resident blocks per SM caps the kernel at 64 registers, as
// for the compact stage.
__global__ void __launch_bounds__(BX * BY, 4)
cov_stage_inkernel_kernel(const Params p) {
  __shared__ float s_h[TY + 2 * AP][TX + 2 * AP];
  __shared__ float s_ua[TY + 2][TX + 2];
  __shared__ float s_ub[TY + 2][TX + 2];
  __shared__ AdvScratch s_adv;

  const int n = p.n, hh = p.halo, m = n + 2 * hh, R = 12 * hh;
  const int f = blockIdx.z;
  const int i0 = blockIdx.x * TX, j0 = blockIdx.y * TY;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long mm = (long)m * m;
  const float* q[3] = {p.hc + f * mm, p.uc + f * mm, p.uc + (6 + f) * mm};
  const float* gi = p.gi + (long)f * (R + 4) * n;
  float* so = p.so + (long)f * R * n;

  // ---- 1. stage the tile with its aprons --------------------------------
  for (int ly = ty; ly < TY + 2 * AP; ly += BY)
    for (int lx = tx; lx < TX + 2 * AP; lx += BX)
      s_h[ly][lx] = frame_in(q[0], gi, 0, n, hh, j0 + ly - AP, i0 + lx - AP);
  for (int ly = ty; ly < TY + 2; ly += BY)
    for (int lx = tx; lx < TX + 2; lx += BX) {
      const int j = j0 + ly - 1, i = i0 + lx - 1;
      s_ua[ly][lx] = frame_in(q[1], gi, 1, n, hh, j, i);
      s_ub[ly][lx] = frame_in(q[2], gi, 2, n, hh, j, i);
    }

  // ---- 2. the ghost ring cells of this tile: a*y0 + b*frame -------------
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
        const long c = f * mm + (long)(j + hh) * m + i + hh;
        for (int fi = 0; fi < 3; ++fi) {
          const float fr = frame_in(q[fi], gi, fi, n, hh, j, i);
          const long cf = c + (fi == 2 ? 6 * mm : 0);
          float v = fr;
          if (p.with_y0)
            v = p.a * (fi == 0 ? p.h0 : p.u0)[cf] + p.bcoef * fr;
          (fi == 0 ? p.ho : p.uo)[cf] = v;
        }
      }
  __syncthreads();

  // ---- 3. tendencies, RK combine, interior and strip stores ------------
  const float* sym = gi + (long)R * n;
  const SymRows rows{sym, sym + n, sym + 2 * n, sym + 3 * n, 1};
  const StageConsts k{p.R2, p.gravity, p.two_omega, p.inv2d, p.inv_d};
  advective_tile<false, TX + 2 * AP, TX + 2>(
      &s_h[0][0], &s_ua[0][0], &s_ub[0][0], s_adv, rows, p.b + f * mm,
      p.xc, p.xf, p.fz + 3 * f, k, n, hh, j0, i0,
      [=](int ly, int lx, int j, int i, float dh, float dua, float dub) {
        const long c = f * mm + (long)(j + hh) * m + i + hh;
        float y0h = 0.0f, y0a = 0.0f, y0b = 0.0f;
        if (p.with_y0) {
          y0h = p.h0[c];
          y0a = p.u0[c];
          y0b = p.u0[6 * mm + c];
        }
        const float vals[3] = {
            combine(p.with_y0, p.a, p.bcoef, p.g_dt, y0h,
                    s_h[ly + AP][lx + AP], dh),
            combine(p.with_y0, p.a, p.bcoef, p.g_dt, y0a,
                    s_ua[ly + 1][lx + 1], dua),
            combine(p.with_y0, p.a, p.bcoef, p.g_dt, y0b,
                    s_ub[ly + 1][lx + 1], dub)};
        p.ho[c] = vals[0];
        p.uo[c] = vals[1];
        p.uo[6 * mm + c] = vals[2];
        for (int fi = 0; fi < 3; ++fi)
          put_packed(so, fi, n, hh, j, i, vals[fi]);
      });
}

}  // namespace

// Launches one stage on `stream`; returns cudaGetLastError() (0 = ok).
// with_y0 == 0: frame + g_dt*L (stage 1); with_y0 != 0: (a*y0 + b*frame)
// + g_dt*L (stages 2-3; h0/u0 read only then).  All tensors float32,
// contiguous, in the layouts of Params.
extern "C" int cov_stage_inkernel_f32(
    const float* h0, const float* u0, const float* hc, const float* uc,
    const float* ghosts, const float* b_ext, const float* xc,
    const float* xf, const float* fz, float* ho, float* uo, float* so,
    int n, int halo, int with_y0,
    float R2, float gravity, float two_omega, float inv2d, float inv_d,
    float a, float b, float g_dt, void* stream) {
  Params p{h0, u0, hc, uc, ghosts, b_ext, xc, xf, fz, ho, uo, so,
           n, halo, with_y0, R2, gravity, two_omega, inv2d, inv_d, a, b,
           g_dt};
  const dim3 grid((n + TX - 1) / TX, (n + TY - 1) / TY, 6);
  const dim3 block(BX, BY);
  cov_stage_inkernel_kernel<<<grid, block, 0,
                              static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
