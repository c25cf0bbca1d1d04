// One fused SSPRK3 stage of the Cartesian shallow-water equations with the
// halo fill inside the kernel: the Hopper (sm_90a) kernel of
// jaxstream_torch's default ShallowWater.make_fused_step(dt).
//
// Replaces the Pallas TPU kernel make_swe_stage_inkernel
// (jaxstream/ops/pallas/swe_step.py:297, pallas_call at :424).  The plain
// PyTorch version of the same function is
// jaxstream_torch.ops.cuda.swe_step.swe_stage_inkernel_reference; the
// kernel reproduces its operations in its order (built with -fmad=false,
// so every multiply and add rounds separately, as PyTorch's do).
//
// What it computes, per face f:
//   frame    each of h, v0, v1, v2 is its whole input block with the four
//            edge ghosts replaced by the routed ghost blocks (fill_ghosts):
//            gsn (6, 2, h, n) the S and N ghost rows as placed, gwe
//            (6, 2, n, h) the W and E ghost columns; the velocity's
//            vgsn (3, 6, 2, h, n) / vgwe (3, 6, 2, n, h).  The ghost
//            corners stay the input's, which no kept output reads.
//   tend     the Cartesian RHS of the frames, as swe_stage.cu computes it
//            (rhs_core_fast when fast != 0, rhs_core otherwise).
//   out      the whole (m, m) block is a*y0 + b*frame (stage 1: the
//            frame); its interior becomes that value + b*dt*tend.  The raw
//            strips of the new interior go out too: sn (6, 2, h, n) its S
//            and N rows, we (6, 2, n, h) its W and E columns (vsn, vwe for
//            the velocity), the next stage's route input.
//
// Design.  As swe_stage.cu, each staged cell taken from the frame above;
// the epilogue also stores the strips.  A W/E strip is (n, h) per face,
// so those stores are strided.
//
// Bound.  Stage 1 reads hc, vc, b (5 x 6 m^2 floats) and the routed
// ghosts (4 x 6 x 4 h n), and writes h, v (4 x 6 m^2) and the strips
// (4 x 6 x 4 h n): at C384 (m = 388) 33.11 MB -> 9.88 us at 3.35 TB/s.
// Stages 2-3 also read h0, v0: 47.56 MB -> 14.20 us.  The float32
// arithmetic is ~2 us at 67 TFLOP/s: bound by memory.  This first design
// is simple and right; TMA / cp.async staging and coalesced strip stores
// are for later.

#include "swe_common.cuh"

namespace {

using namespace swe;

constexpr int AP = 2;      // h apron: PLR reads two cells past a face

struct Params {
  const float* h0;      // (6, m, m) stage base, read only if with_y0
  const float* v0;      // (3, 6, m, m)
  const float* hc;      // (6, m, m) current stage
  const float* vc;      // (3, 6, m, m)
  const float* gsn;     // (6, 2, h, n) routed S/N ghost rows of h
  const float* gwe;     // (6, 2, n, h) routed W/E ghost columns of h
  const float* vgsn;    // (3, 6, 2, h, n)
  const float* vgwe;    // (3, 6, 2, n, h)
  const float* b;       // (6, m, m) orography, ghosts filled
  const float* xc;      // (m,) tan of the cell-center coordinates
  const float* xf;      // (m,) tan of the left-face coordinates
  const float* frames;  // (6, 3, 3) face frames c0, cx, cy
  float* ho;            // (6, m, m)
  float* vo;            // (3, 6, m, m)
  float* sn;            // (6, 2, h, n) raw S/N rows of the new interior
  float* we;            // (6, 2, n, h) raw W/E columns
  float* vsn;           // (3, 6, 2, h, n)
  float* vwe;           // (3, 6, 2, n, h)
  int n, halo, with_y0;
  Consts k;
  float a, bcoef, g_dt;
};

// The stage's frame of one field at face-local (j, i): the input block q
// (m x m) with its edge ghosts from the face's routed blocks gs (2, h, n)
// and gw (2, n, h).  0 past the frame (the ragged last tiles' aprons,
// which feed no kept output).
__device__ __forceinline__ float frame_in(const float* __restrict__ q,
                                          const float* __restrict__ gs,
                                          const float* __restrict__ gw,
                                          int n, int hh, int j, int i) {
  if (j < -hh || j >= n + hh || i < -hh || i >= n + hh) return 0.0f;
  const bool jin = j >= 0 && j < n;
  const bool iin = i >= 0 && i < n;
  if (iin && !jin) return gs[(j < 0 ? j + hh : hh + j - n) * n + i];
  if (jin && !iin) return gw[(i < 0 ? j : n + j) * hh + (i < 0 ? i + hh
                                                                : i - n)];
  return q[(j + hh) * (n + 2 * hh) + i + hh];
}

// At least 4 resident blocks per SM caps the kernel at 64 registers.
template <bool Fast_>
__global__ void __launch_bounds__(BX * BY, 4)
swe_stage_inkernel_kernel(const Params p) {
  __shared__ float s_h[TY + 2 * AP][TX + 2 * AP];
  __shared__ float s_v[3][TY + 2][TX + 2];
  __shared__ float s_fr[9];
  __shared__ Scratch s;

  const int n = p.n, hh = p.halo, m = n + 2 * hh;
  const int f = blockIdx.z;
  const int i0 = blockIdx.x * TX, j0 = blockIdx.y * TY;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long mm = (long)m * m, sw = 2L * hh * n;
  // Field q: 0 = h, 1..3 = v components: face f's block index, its routed
  // ghost blocks and its strip blocks.
  auto blk = [&](int q) { return q == 0 ? f : (q - 1) * 6 + f; };
  auto gs = [&](int q) { return (q == 0 ? p.gsn : p.vgsn) + blk(q) * sw; };
  auto gw = [&](int q) { return (q == 0 ? p.gwe : p.vgwe) + blk(q) * sw; };
  auto in = [&](int q) { return (q == 0 ? p.hc : p.vc) + blk(q) * mm; };

  // ---- 1. stage the tile with its aprons, and the face frame ----------
  for (int ly = ty; ly < TY + 2 * AP; ly += BY)
    for (int lx = tx; lx < TX + 2 * AP; lx += BX)
      s_h[ly][lx] = frame_in(in(0), gs(0), gw(0), n, hh, j0 + ly - AP,
                             i0 + lx - AP);
  for (int ly = ty; ly < TY + 2; ly += BY)
    for (int lx = tx; lx < TX + 2; lx += BX)
      for (int c = 0; c < 3; ++c)
        s_v[c][ly][lx] = frame_in(in(1 + c), gs(1 + c), gw(1 + c), n, hh,
                                  j0 + ly - 1, i0 + lx - 1);
  if (ty == 0 && tx < 9) s_fr[tx] = p.frames[9 * f + tx];

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
        const long c = (long)(j + hh) * m + i + hh;
        for (int q = 0; q < 4; ++q) {
          const long cq = blk(q) * mm + c;
          const float fr = frame_in(in(q), gs(q), gw(q), n, hh, j, i);
          const float v =
              p.with_y0 ? p.a * (q == 0 ? p.h0 : p.v0)[cq] + p.bcoef * fr
                        : fr;
          (q == 0 ? p.ho : p.vo)[cq] = v;
        }
      }
  __syncthreads();

  // ---- 3. tendencies, RK combine, interior and strip stores ------------
  swe_tile<Fast_>(
      &s_h[0][0], &s_v[0][0][0], s, s_fr, p.b + f * mm, p.xc, p.xf, p.k, n,
      hh, j0, i0,
      [=](int ly, int lx, int j, int i, float dh, float dv0, float dv1,
          float dv2) {
        const long c = (long)(j + hh) * m + i + hh;
        const float tend[4] = {dh, dv0, dv1, dv2};
        for (int q = 0; q < 4; ++q) {
          const long cq = blk(q) * mm + c;
          const float yc = q == 0 ? s_h[ly + AP][lx + AP]
                                  : s_v[q - 1][ly + 1][lx + 1];
          const float y0 = p.with_y0 ? (q == 0 ? p.h0 : p.v0)[cq] : 0.0f;
          const float val = cov::combine(p.with_y0, p.a, p.bcoef, p.g_dt,
                                         y0, yc, tend[q]);
          (q == 0 ? p.ho : p.vo)[cq] = val;
          float* so = (q == 0 ? p.sn : p.vsn) + blk(q) * sw;
          float* wo = (q == 0 ? p.we : p.vwe) + blk(q) * sw;
          if (j < hh) so[j * n + i] = val;
          if (j >= n - hh) so[(hh + j - (n - hh)) * n + i] = val;
          if (i < hh) wo[j * hh + i] = val;
          if (i >= n - hh) wo[(n + j) * hh + i - (n - hh)] = val;
        }
      });
}

}  // namespace

// Launches one stage on `stream`; returns cudaGetLastError() (0 = ok).
// with_y0 == 0: frame + g_dt*L (stage 1; h0/v0 not read); with_y0 != 0:
// (a*y0 + b*frame) + g_dt*L.  fast != 0 selects rhs_core_fast.  All
// tensors float32, contiguous, in the layouts of Params.
extern "C" int swe_stage_inkernel_f32(
    const float* h0, const float* v0, const float* hc, const float* vc,
    const float* gsn, const float* gwe, const float* vgsn,
    const float* vgwe, const float* b_ext, const float* xc, const float* xf,
    const float* frames, float* ho, float* vo, float* sn, float* we,
    float* vsn, float* vwe, int n, int halo, int with_y0, int fast,
    float R, float R2, float gravity, float two_omega, float inv2d,
    float inv_d, float a, float b, float g_dt, void* stream) {
  Params p{h0, v0, hc, vc, gsn, gwe, vgsn, vgwe, b_ext, xc, xf, frames,
           ho, vo, sn, we, vsn, vwe, n, halo, with_y0,
           Consts{R, R2, gravity, two_omega, inv2d, inv_d}, a, b, g_dt};
  const dim3 grid((n + TX - 1) / TX, (n + TY - 1) / TY, 6);
  const dim3 block(BX, BY);
  auto kern = fast ? swe_stage_inkernel_kernel<true>
                   : swe_stage_inkernel_kernel<false>;
  kern<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
