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
// Bound.  Stage 1 reads hc, vc and b (5 x 6 m^2 floats) and writes h, v
// (4 x 6 m^2): at C384 (m = 388) 32.52 MB -> 9.71 us at 3.35 TB/s.
// Stages 2-3 also read h0, v0: 46.97 MB -> 14.02 us.  The float32
// arithmetic (~380 flops per cell with the fast core) is ~2 us at
// 67 TFLOP/s: bound by memory.  A launch's bytes fit the 50 MB L2, so what
// a tile-per-block kernel spends instead is latency and instructions:
// scalar, branchy staging that nothing overlaps, a ghost ring written by
// two lanes of a warp per row, and the metric rebuilt at every band cell,
// face and centre of every face.
//
// Design.  swe_stage_inkernel.cu's (B11's) faces-in-block body with the
// input blocks as the frame (halo >= 2 puts every apron cell inside the
// m x m block, so no ghost is routed here): a block of 256 threads takes
// one 32 x 24 tile position and a group of three faces (cov_faces.cuh,
// swe_faces.cuh), a grid of (ceil(n/32), ceil(n/24), 2), 12 x 16 x 2 =
// 384 blocks at C384.  The block
//   1. issues the asynchronous copies (cp.async) of its first face's
//      window (h with a 2-deep apron, v0, v1, v2 with a 1-deep one, b on
//      the Bernoulli band; 0 past the frame), then writes the ghost ring
//      cells it owns (cov::FrameRing: the cells an edge tile owns, of all
//      three faces in one flat list, one cell a thread and pass: a*y0 +
//      b*yc of the four fields; a corner tile owns 348 cells at C384);
//   2. computes the tile's face-independent terms once into shared memory
//      while the window lands: the fast core's metric (SweMetric), or the
//      general core's divisions (SweBasis, as swe_rhs.cu), and loads the
//      three face frames;
//   3. per face of its group: issues the next face's window into the other
//      buffer, loads the combine's y0 at its cells, waits for this face's
//      window, runs swe_face_tile, and stores the combine into the block.
// Occupancy: 67 420 B of dynamic shared memory (two windows 2 x 18 800,
// metric 12 736 or basis 12 512, scratch 16 976, frames 108) and
// __launch_bounds__(256, 3): 3 blocks (24 warps) per SM, <= 80 registers.
// 384 blocks on 132 SMs x 3 slots = 396: one wave.

#include "swe_faces.cuh"

namespace {

using namespace cov;
using namespace swe;

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

struct Smem {
  SweWindow w[2];     // this face's window and the next one's
  union {
    SweMetric mt;     // the fast core's metric terms
    SweBasis bt;      // the general core's divisions
  };
  SweScratch s;
  float fr[FPB][9];   // the group's face frames
};

// Block of field q (0 = h, 1..3 = the v components) of face f in the
// (6, m, m) / (3, 6, m, m) arrays.
__device__ __forceinline__ long block_of(int q, int f, long mm) {
  return (q == 0 ? f : (q - 1) * 6 + f) * mm;
}

// A thread's ring cell of one pass: yc of the four fields.  One cell a
// thread, y0 read at the store: more held in registers at once spilled at
// the 80-register cap in cov_stage_nbr.cu.
struct RingCell {
  float yc[4];
  long cell;   // offset in the (m, m) block; -1: none
  int face;
};

// Issues the loads of the thread's ring cell k0 + t.
__device__ __forceinline__ void ring_load(const Params& p,
                                          const FrameRing& g, int f0,
                                          int j0, int k0, RingCell& rc) {
  const int n = p.n, hh = p.halo, m = n + 2 * hh;
  const long mm = (long)m * m;
  const int kf = k0 + threadIdx.y * BX + threadIdx.x;
  rc.cell = -1;
  if (kf >= g.count) return;
  int q, j, i;
  g.at(kf, n, hh, j0, q, j, i);
  rc.face = f0 + q;
  rc.cell = (long)(j + hh) * m + i + hh;
#pragma unroll
  for (int fi = 0; fi < 4; ++fi)
    rc.yc[fi] = (fi == 0 ? p.hc : p.vc)[block_of(fi, rc.face, mm) + rc.cell];
}

// Stores a*y0 + b*yc (stage 1: yc) at the cell ring_load loaded.
__device__ __forceinline__ void ring_store(const Params& p,
                                           const RingCell& rc) {
  if (rc.cell < 0) return;
  const long mm = (long)(p.n + 2 * p.halo) * (p.n + 2 * p.halo);
#pragma unroll
  for (int fi = 0; fi < 4; ++fi) {
    const long c = block_of(fi, rc.face, mm) + rc.cell;
    (fi == 0 ? p.ho : p.vo)[c] =
        p.with_y0 ? p.a * (fi == 0 ? p.h0 : p.v0)[c] + p.bcoef * rc.yc[fi]
                  : rc.yc[fi];
  }
}

// The three faces of the block's group on one tile position.
template <bool Fast_>
__device__ __forceinline__ void stage_faces(const Params& p, Smem& sm,
                                            int f0, int j0, int i0) {
  const int n = p.n, hh = p.halo, m = n + 2 * hh;
  const long mm = (long)m * m;
  const int lx = threadIdx.x;
  // The first window's copies, then the ring, one pass of the block at a
  // time.  (Its first pass's loads issued ahead of the copies, as B11's
  // are, measured slower here: the registers they hold over the copies'
  // issue.)
  stage_frame_window(sm.w[0], p.hc, p.vc, p.b, f0, n, hh, j0, i0);
  async_commit();
  const FrameRing ring(n, hh, j0, i0);
  for (int k0 = 0; k0 < ring.count; k0 += NT) {
    RingCell rc;
    ring_load(p, ring, f0, j0, k0, rc);
    ring_store(p, rc);
  }
  if (Fast_)
    swe_metric(sm.mt, p.xc, p.xf, p.k, n, hh, j0, i0);
  else
    swe_basis(sm.bt, p.xc, p.xf, p.k, n, hh, j0, i0);
  {
    const int t = threadIdx.y * BX + threadIdx.x;
    if (t < FPB * 9) sm.fr[t / 9][t % 9] = p.frames[9 * f0 + t];
  }

  for (int q = 0; q < FPB; ++q) {
    const int f = f0 + q, cur = q & 1;
    if (q + 1 < FPB) {
      stage_frame_window(sm.w[cur ^ 1], p.hc, p.vc, p.b, f + 1, n, hh, j0,
                         i0);
      async_commit();
    }
    // The combine's y0 at the thread's cells, loaded ahead of the
    // arithmetic.
    float y0[FTY / BY][4] = {};
    if (p.with_y0) {
#pragma unroll
      for (int r = 0; r < FTY / BY; ++r) {
        const int j = j0 + threadIdx.y + r * BY, i = i0 + lx;
        if (j < n && i < n) {
          const long c = (long)(j + hh) * m + i + hh;
#pragma unroll
          for (int fi = 0; fi < 4; ++fi)
            y0[r][fi] = (fi == 0 ? p.h0 : p.v0)[block_of(fi, f, mm) + c];
        }
      }
    }
    if (q + 1 < FPB)
      async_wait<1>();
    else
      async_wait<0>();
    __syncthreads();   // this face's window (and, first, mt) complete

    const SweWindow& w = sm.w[cur];
    auto epi = [&](int r, int ly, int lx_, int j, int i, float dh,
                   float dv0, float dv1, float dv2) {
      const long c = (long)(j + hh) * m + i + hh;
      const float tend[4] = {dh, dv0, dv1, dv2};
#pragma unroll
      for (int fi = 0; fi < 4; ++fi) {
        const float yc = fi == 0 ? w.h[ly + 2][WOFF + lx_]
                                 : w.v[fi - 1][ly + 1][WOFF + lx_];
        (fi == 0 ? p.ho : p.vo)[block_of(fi, f, mm) + c] =
            combine(p.with_y0, p.a, p.bcoef, p.g_dt, y0[r][fi], yc,
                    tend[fi]);
      }
    };
    if constexpr (Fast_)
      swe_face_tile<true>(w, sm.mt, sm.s, sm.fr[q], p.xc, p.xf, p.k, n, hh,
                          j0, i0, epi);
    else
      swe_face_tile<false>(w, sm.bt, sm.s, sm.fr[q], p.xc, p.xf, p.k, n, hh,
                           j0, i0, epi);
    __syncthreads();   // w and the scratch are free for the next face
  }
}

// The launch parameters of one core: a type per kernel, so that
// dynamic_smem_limit keeps a flag for each.
template <bool Fast_>
struct CoreParams : Params {};

template <bool Fast_>
__global__ void __launch_bounds__(NT, 3)
swe_stage_kernel(const CoreParams<Fast_> p) {
  extern __shared__ float smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  stage_faces<Fast_>(p, sm, blockIdx.z * FPB, blockIdx.y * FTY,
                     blockIdx.x * FTX);
}

template <bool Fast_>
int launch(const Params& p, void* stream) {
  void (*kern)(const CoreParams<Fast_>) = swe_stage_kernel<Fast_>;
  const int rc = dynamic_smem_limit(kern, sizeof(Smem));
  if (rc != 0) return rc;
  const CoreParams<Fast_> cp{p};
  const dim3 grid((p.n + FTX - 1) / FTX, (p.n + FTY - 1) / FTY, 6 / FPB);
  const dim3 block(BX, BY);
  const size_t smem = sizeof(Smem);
  kern<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(cp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches one stage on `stream`; returns the cudaError_t of the shared
// memory attribute or of the launch (0 = ok).  with_y0 == 0: yc + g_dt*L
// (stage 1; h0/v0 not read); with_y0 != 0: (a*y0 + b*yc) + g_dt*L.
// fast != 0 selects rhs_core_fast.  All tensors float32, contiguous, in
// the layouts of Params.
extern "C" int swe_stage_f32(
    const float* h0, const float* v0, const float* hc, const float* vc,
    const float* b_ext, const float* xc, const float* xf,
    const float* frames, float* ho, float* vo, int n, int halo, int with_y0,
    int fast, float R, float R2, float gravity, float two_omega,
    float inv2d, float inv_d, float a, float b, float g_dt, void* stream) {
  Params p{h0, v0, hc, vc, b_ext, xc, xf, frames, ho, vo, n, halo, with_y0,
           Consts{R, R2, gravity, two_omega, inv2d, inv_d}, a, b, g_dt};
  return fast ? launch<true>(p, stream) : launch<false>(p, stream);
}
