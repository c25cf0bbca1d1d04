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
// Bound.  Stage 1 reads hc, vc, b (5 x 6 m^2 floats) and the routed
// ghosts (4 x 6 x 4 h n), and writes h, v (4 x 6 m^2) and the strips
// (4 x 6 x 4 h n): at C384 (m = 388) 33.11 MB -> 9.88 us at 3.35 TB/s.
// Stages 2-3 also read h0, v0: 47.56 MB -> 14.20 us.  The float32
// arithmetic (380 flops per cell) is ~2 us at 67 TFLOP/s: bound by memory.
// A launch's bytes fit the 50 MB L2, so what a tile-per-block kernel
// spends instead is latency and instructions: scalar, branchy staging that
// nothing overlaps, and the closed-form metric (fast_frame: an rsqrtf and
// three IEEE divisions) rebuilt at every band cell, face and centre of
// every face, though all six faces of a tile position compute the same
// floats.
//
// Design.  A block of 256 threads takes one 32 x 24 tile position and a
// group of three faces (cov_faces.cuh, swe_faces.cuh): the grid is
// (ceil(n/32), ceil(n/24), 2), 12 x 16 x 2 = 384 blocks at C384.  The
// block
//   1. issues the asynchronous copies (cp.async) of its first face's
//      window: h with a 2-deep apron, v0, v1, v2 with a 1-deep one (each
//      cell from the input block or the face's routed ghost block, as the
//      frame above has it; 0 past the frame), b on the Bernoulli band;
//   2. meanwhile writes the ghost ring cells an edge tile owns, of all
//      three faces in one pass (a*y0 + b*frame, from the inputs; the
//      loads issued ahead of the first window's copies, every load before
//      a store), computes (fast core) the tile's face-independent metric
//      terms once into shared memory (SweMetric), and loads the three
//      face frames;
//   3. per face of its group: issues the next face's window into the
//      other buffer, loads the combine's y0 at its cells, waits for this
//      face's window, and runs the band, the fluxes and the tendencies
//      from shared memory, then the combine, the interior and strip
//      stores.
// Every per-cell phase maps one tile column to one lane (for_region).
// Occupancy: 67 420 B of dynamic shared memory (two windows 2 x 18 800,
// metric 12 736, scratch 16 976, frames 108) and __launch_bounds__(256,
// 3): 3 blocks (24 warps) per SM, <= 80 registers.  384 blocks on 132 SMs
// x 3 slots = 396: one wave.

#include "swe_faces.cuh"

namespace {

using namespace cov;
using namespace swe;

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

struct Smem {
  SweWindow w[2];     // this face's window and the next one's
  SweMetric mt;
  SweScratch s;
  float fr[FPB][9];   // the group's face frames
};

// The stage's frame of one field at face-local (j, i): the input block q
// (m x m) with its edge ghosts from the face's routed blocks gs (2, h, n)
// and gw (2, n, h); nullptr past the frame (the ragged last tiles'
// aprons, which feed no kept output).
__device__ __forceinline__ const float* frame_src(
    const float* __restrict__ q, const float* __restrict__ gs,
    const float* __restrict__ gw, int n, int hh, int j, int i) {
  if (j < -hh || j >= n + hh || i < -hh || i >= n + hh) return nullptr;
  const bool jin = j >= 0 && j < n;
  const bool iin = i >= 0 && i < n;
  if (iin && !jin) return gs + (j < 0 ? j + hh : hh + j - n) * n + i;
  if (jin && !iin)
    return gw + (i < 0 ? j : n + j) * hh + (i < 0 ? i + hh : i - n);
  return q + (j + hh) * (n + 2 * hh) + i + hh;
}

// Field q of face f: 0 = h, 1..3 = the v components.
struct Field {
  const float* in;   // (m, m) input block
  const float* gs;   // (2, h, n) routed S/N ghosts
  const float* gw;   // (2, n, h) routed W/E ghosts
};

__device__ __forceinline__ Field field(const Params& p, int q, int f) {
  const int n = p.n, hh = p.halo, m = n + 2 * hh;
  const long mm = (long)m * m, sw = 2L * hh * n;
  const int blk = q == 0 ? f : (q - 1) * 6 + f;
  return Field{(q == 0 ? p.hc : p.vc) + blk * mm,
               (q == 0 ? p.gsn : p.vgsn) + blk * sw,
               (q == 0 ? p.gwe : p.vgwe) + blk * sw};
}

// Issues the copies of rows jw .. jw+ROWS-1, columns i0-A .. i0+FTX+A-1
// of field fl's frame into s (row stride WS, tile column c at s[r * WS +
// WOFF + c]); 0 past the frame.
template <int ROWS, int A>
__device__ __forceinline__ void stage_frame_field(float* s, const Field& fl,
                                                  int n, int hh, int jw,
                                                  int i0) {
  for_region<ROWS, FTX + 2 * A>([&](int r, int cc) {
    const int c = cc - A;
    float* dst = s + r * WS + WOFF + c;
    const float* src = frame_src(fl.in, fl.gs, fl.gw, n, hh, jw + r, i0 + c);
    if (src != nullptr)
      async_copy4(dst, src);
    else
      *dst = 0.0f;
  });
}

// Issues the copies of face f's window into w (no commit).  (16-byte
// copies of an interior tile's rows measured slower on the H100: 46.71 /
// 48.67 against 46.31 / 47.77 us at C384, stages 1 / 2.)
__device__ __forceinline__ void stage_window(const Params& p, SweWindow& w,
                                             int f, int j0, int i0) {
  const int n = p.n, hh = p.halo, m = n + 2 * hh;
  stage_frame_field<FTY + 4, 2>(&w.h[0][0], field(p, 0, f), n, hh, j0 - 2,
                                i0);
  for (int c = 0; c < 3; ++c)
    stage_frame_field<FTY + 2, 1>(&w.v[c][0][0], field(p, 1 + c, f), n, hh,
                                  j0 - 1, i0);
  cov::stage_band(w.b, p.b + (long)f * m * m, n, hh, j0, i0);
}

// The ghost ring cells of the group's faces f0 .. f0+FPB-1 that the tile
// at (j0, i0) owns (those whose nearest interior cell it holds; interior
// tiles own none): a*y0 + b*frame, from the inputs.  The cells (at most
// 116 per face for a corner tile at halo 2) are listed flat over the
// faces, S and N rows (with the corners) first, then W and E columns; a
// thread takes up to two of them per pass of the block.
struct Ring {
  int ilo, cols;          // the S/N rows' first column and width
  int ns, nn, nw, count;  // S, N, W cells per face; all cells of the group

  __device__ __forceinline__ Ring(int n, int hh, int j0, int i0) {
    const bool s_edge = j0 == 0, n_edge = j0 + FTY >= n;
    const bool w_edge = i0 == 0, e_edge = i0 + FTX >= n;
    const int rows = (n_edge ? n : j0 + FTY) - j0;   // W/E column height
    ilo = w_edge ? -hh : i0;
    cols = (e_edge ? n + hh : i0 + FTX) - ilo;
    ns = s_edge ? hh * cols : 0;
    nn = n_edge ? hh * cols : 0;
    nw = w_edge ? hh * rows : 0;
    count = FPB * (ns + nn + nw + (e_edge ? hh * rows : 0));
  }
};

// One pass's ring cells of a thread: their inputs (the frame and y0 of
// the four fields), loaded before anything waits on them.
struct RingPass {
  float fr[2][4], y0[2][4];
  long cell[2];   // offset in the (m, m) block; -1: none
  int face[2];
};

// Issues the loads of the thread's ring cells k0 + t and k0 + t + NT.
__device__ __forceinline__ void ring_load(const Params& p, const Ring& g,
                                          int f0, int j0, int k0,
                                          RingPass& rp) {
  const int n = p.n, hh = p.halo, m = n + 2 * hh;
  const long mm = (long)m * m;
  const int per_face = g.count / FPB;
  const int t = threadIdx.y * cov::BX + threadIdx.x;
  for (int u = 0; u < 2; ++u) {
    rp.cell[u] = -1;
    const int kf = k0 + t + u * NT;
    if (kf >= g.count) continue;
    const int f = f0 + kf / per_face, k = kf % per_face;
    int j, i;
    if (k < g.ns + g.nn) {              // S or N rows
      const int r = k < g.ns ? k : k - g.ns, row = r / g.cols;
      j = k < g.ns ? -hh + row : n + row;
      i = g.ilo + r - row * g.cols;
    } else {                            // W or E columns
      const int r = k - g.ns - g.nn;
      const int rr = r < g.nw ? r : r - g.nw, row = rr / hh;
      j = j0 + row;
      i = r < g.nw ? -hh + rr - row * hh : n + rr - row * hh;
    }
    rp.face[u] = f;
    rp.cell[u] = (long)(j + hh) * m + i + hh;
    for (int q = 0; q < 4; ++q) {
      const Field fl = field(p, q, f);
      rp.fr[u][q] = *frame_src(fl.in, fl.gs, fl.gw, n, hh, j, i);
      rp.y0[u][q] = p.with_y0 ? (q == 0 ? p.h0 : p.v0)[
          (q == 0 ? f : (q - 1) * 6 + f) * mm + rp.cell[u]] : 0.0f;
    }
  }
}

// Combines and stores the cells ring_load loaded.
__device__ __forceinline__ void ring_store(const Params& p,
                                           const RingPass& rp) {
  const int m = p.n + 2 * p.halo;
  const long mm = (long)m * m;
  for (int u = 0; u < 2; ++u) {
    if (rp.cell[u] < 0) continue;
    const int f = rp.face[u];
    for (int q = 0; q < 4; ++q)
      (q == 0 ? p.ho : p.vo)[(q == 0 ? f : (q - 1) * 6 + f) * mm
                             + rp.cell[u]] =
          p.with_y0 ? p.a * rp.y0[u][q] + p.bcoef * rp.fr[u][q]
                    : rp.fr[u][q];
  }
}

// The three faces of the block's group on one tile position.
template <bool Fast_>
__device__ __forceinline__ void stage_faces(const Params& p, Smem& sm,
                                            int f0, int j0, int i0) {
  const int n = p.n, hh = p.halo, m = n + 2 * hh;
  const long mm = (long)m * m, sw = 2L * hh * n;
  const int lx = threadIdx.x;
  // The tile holds cells of the boundary strips.
  const bool strips = j0 < hh || i0 < hh || j0 + FTY > n - hh
                      || i0 + FTX > n - hh;
  // The ring's first pass: its loads ahead of the first window's copies
  // (all blocks stage their first window at once, and loads issued after
  // those wait behind them), its stores after.
  const Ring ring(n, hh, j0, i0);
  RingPass rp;
  ring_load(p, ring, f0, j0, 0, rp);
  stage_window(p, sm.w[0], f0, j0, i0);
  async_commit();
  ring_store(p, rp);
  for (int k0 = 2 * NT; k0 < ring.count; k0 += 2 * NT) {   // small n only
    ring_load(p, ring, f0, j0, k0, rp);
    ring_store(p, rp);
  }
  if (Fast_) swe_metric(sm.mt, p.xc, p.xf, p.k, n, hh, j0, i0);
  {
    const int t = threadIdx.y * cov::BX + threadIdx.x;
    if (t < FPB * 9) sm.fr[t / 9][t % 9] = p.frames[9 * f0 + t];
  }

  for (int q = 0; q < FPB; ++q) {
    const int f = f0 + q, cur = q & 1;
    if (q + 1 < FPB) {
      stage_window(p, sm.w[cur ^ 1], f + 1, j0, i0);
      async_commit();
    }
    // The combine's y0 at the thread's cells, loaded ahead of the
    // arithmetic.
    float y0[FTY / cov::BY][4] = {};
    if (p.with_y0) {
#pragma unroll
      for (int r = 0; r < FTY / cov::BY; ++r) {
        const int j = j0 + threadIdx.y + r * cov::BY, i = i0 + lx;
        if (j < n && i < n) {
          const long c = (long)(j + hh) * m + i + hh;
          y0[r][0] = p.h0[f * mm + c];
          for (int d = 0; d < 3; ++d) y0[r][1 + d] = p.v0[(d * 6 + f) * mm + c];
        }
      }
    }
    if (q + 1 < FPB)
      async_wait<1>();
    else
      async_wait<0>();
    __syncthreads();   // this face's window (and, first, mt) complete

    const SweWindow& w = sm.w[cur];
    swe_face_tile<Fast_>(
        w, sm.mt, sm.s, sm.fr[q], p.xc, p.xf, p.k, n, hh, j0, i0,
        [&](int r, int ly, int lx_, int j, int i, float dh, float dv0,
            float dv1, float dv2) {
          const long c = (long)(j + hh) * m + i + hh;
          const float tend[4] = {dh, dv0, dv1, dv2};
          for (int fi = 0; fi < 4; ++fi) {
            const int blk = fi == 0 ? f : (fi - 1) * 6 + f;
            const float yc = fi == 0 ? w.h[ly + 2][WOFF + lx_]
                                     : w.v[fi - 1][ly + 1][WOFF + lx_];
            const float val = cov::combine(p.with_y0, p.a, p.bcoef, p.g_dt,
                                           y0[r][fi], yc, tend[fi]);
            (fi == 0 ? p.ho : p.vo)[blk * mm + c] = val;
            if (strips) {
              float* so = (fi == 0 ? p.sn : p.vsn) + blk * sw;
              float* wo = (fi == 0 ? p.we : p.vwe) + blk * sw;
              if (j < hh) so[j * n + i] = val;
              if (j >= n - hh) so[(hh + j - (n - hh)) * n + i] = val;
              if (i < hh) wo[j * hh + i] = val;
              if (i >= n - hh) wo[(n + j) * hh + i - (n - hh)] = val;
            }
          }
        });
    __syncthreads();   // w and the scratch are free for the next face
  }
}

// The launch parameters of one core: a type per kernel, so that
// dynamic_smem_limit keeps a flag for each.
template <bool Fast_>
struct CoreParams : Params {};

template <bool Fast_>
__global__ void __launch_bounds__(NT, 3)
swe_stage_inkernel_kernel(const CoreParams<Fast_> p) {
  extern __shared__ float smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  stage_faces<Fast_>(p, sm, blockIdx.z * FPB, blockIdx.y * FTY,
                     blockIdx.x * FTX);
}

template <bool Fast_>
int launch(const Params& p, void* stream) {
  void (*kern)(const CoreParams<Fast_>) = swe_stage_inkernel_kernel<Fast_>;
  const int rc = cov::dynamic_smem_limit(kern, sizeof(Smem));
  if (rc != 0) return rc;
  const CoreParams<Fast_> cp{p};
  const dim3 grid((p.n + FTX - 1) / FTX, (p.n + FTY - 1) / FTY, 6 / FPB);
  const dim3 block(cov::BX, cov::BY);
  const size_t smem = sizeof(Smem);
  kern<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(cp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches one stage on `stream`; returns the cudaError_t of the shared
// memory attribute or of the launch (0 = ok).  with_y0 == 0: frame +
// g_dt*L (stage 1; h0/v0 not read); with_y0 != 0: (a*y0 + b*frame) +
// g_dt*L.  fast != 0 selects rhs_core_fast.  All tensors float32,
// contiguous, in the layouts of Params.

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
  return fast ? launch<true>(p, stream) : launch<false>(p, stream);
}
