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
//            cov_stage.cu computes it, h's face states by the launch's
//            reconstruction (PLR with one of the five limiters, or PPM at
//            halo >= 3).
//   out      the whole (m, m) block is val = a*y0 + b*frame (stage 1:
//            the frame); its interior becomes val + b*dt*tend.  So the
//            ghost ring holds a*y0 + b*(routed ghost) and the corners
//            a*y0 + b*(input corner), as the TPU kernel writes them;
//            every cell is written once.  The new packed strips (6, 12h,
//            n) are the interior's S rows, N rows, W and E columns
//            transposed (pack_strips_cov).
//
// Bound.  Stage 1 reads hc, u_a, u_b and b (4 x 6 m^2 floats) and the
// routed ghosts (6 (12h+4) n), and writes h, u_a, u_b (3 x 6 m^2) and
// the strips (6 x 12h n): at C384 (m = 388) 25.77 MB -> 7.69 us at
// 3.35 TB/s.  Stages 2-3 also read h0, u0: 36.61 MB -> 10.93 us.  The
// float32 arithmetic (~137 flops per cell) is ~1.8 us at 67 TFLOP/s:
// bound by memory.  A launch's bytes fit the 50 MB L2, so what a
// tile-per-block kernel spends instead is latency and instructions
// (cov_stage.cu), here also a ghost-ring loop that walked an edge tile at
// two lanes per warp, each load after the last store.
//
// Design.  cov_stage.cu's (B1's) faces-in-block body on the extended
// carry, with swe_stage_inkernel.cu's (B11's) ring: a block of 256
// threads takes one 32 x 24 tile position and a group of three faces
// (cov_faces.cuh): the grid is (ceil(n/32), ceil(n/24), 2), 12 x 16 x 2 =
// 384 blocks at C384.  The block
//   1. loads the ghost ring cells it owns, of all three faces in one flat
//      pass (FrameRing: frame and y0 of the three fields, two cells a
//      thread), then issues the asynchronous copies (cp.async) of its
//      first face's window: h with the reconstruction's apron (2 deep for
//      PLR, 3 for PPM), u_a and u_b with a 1-deep one, each cell from the
//      input block or, past the face edge,
//      the routed ghosts (0 past the frame), b on the Bernoulli band; then
//      stores the ring (a*y0 + b*frame).  All blocks issue their first
//      window at once, and loads issued after those wait behind them;
//   2. computes the tile's face-independent metric terms once into shared
//      memory (StageMetric) while the window lands;
//   3. per face of its group: issues the next face's window into the
//      other buffer, loads the combine's y0 at its cells, waits for this
//      face's window, and runs stage_face_tile<Seam::Frame> with the
//      face's routed sym rows, then the combine, the whole-block and the
//      packed strip stores.  The W/E strip stores turn a face column into
//      a strip row, so they are strided: 2 lanes of a warp per strip row
//      of an edge tile.  (Staged through shared memory and stored as
//      coalesced rows after the face's closing barrier, they measured
//      ~2.4 us slower per launch on an H100 80GB HBM3 at 700 W,
//      scripts/torch_faces_probe.py.)
// Occupancy: B1's 72 576 B of dynamic shared memory (two windows
// 2 x 15 056, metric 32 560, scratch 9 904; PPM's 3-deep h apron adds
// 2 x 528) and __launch_bounds__(256, 3): 3 blocks (24 warps) per SM,
// <= 80 registers; 384 blocks on 132 SMs x 3 slots = 396: one wave.
// The ring and the strips are any halo's: at halo 3 a corner tile owns
// 177 ring cells per face, and a group's 531 take two passes.
//
// Modes.  The body is a template on the face-state policy of
// cov_common.cuh; each of the six reconstructions is its own kernel and
// its own C entry point (cov_stage_inkernel_<mode>_f32; PLR-MC keeps the
// kernel cov_stage_inkernel_kernel and the entry cov_stage_inkernel_f32).

#include "cov_faces.cuh"

namespace {

using namespace cov;

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

template <class R>
struct Smem {
  StageWindowR<R> w[2];   // this face's window and the next one's
  StageMetric mt;
  StageScratch s;
};

// Block fi (0 = h, 1 = u_a, 2 = u_b) of face f in the (6, m, m) / (2, 6,
// m, m) arrays.
__device__ __forceinline__ long block_of(int fi, int f, long mm) {
  return (fi == 2 ? 6 + f : f) * mm;
}

// Where the stage's frame of field fi at face-local (j, i) comes from: the
// face's input block q (m x m; interior and ghost corners) or its routed
// ghosts gi (12h+4, n); nullptr past the frame (the ragged last tiles'
// aprons, which feed no kept output).
__device__ __forceinline__ const float* routed_src(
    const float* __restrict__ q, const float* __restrict__ gi, int fi, int n,
    int hh, int j, int i) {
  if (j < -hh || j >= n + hh || i < -hh || i >= n + hh) return nullptr;
  const bool jin = j >= 0 && j < n;
  const bool iin = i >= 0 && i < n;
  const int base = fi * 4 * hh;
  if (iin && !jin)
    return gi + (j < 0 ? base + j + hh : base + hh + j - n) * n + i;
  if (jin && !iin)
    return gi + (i < 0 ? base + 2 * hh + i + hh : base + 3 * hh + i - n) * n
           + j;
  return q + (j + hh) * (n + 2 * hh) + i + hh;
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

// Issues the copies of rows jw .. jw+ROWS-1, columns i0-A .. i0+FTX+A-1
// of field fi's frame into s (row stride S, tile column c at s[r * S +
// OFF + c]; OFF >= A); 0 past the frame.
template <int ROWS, int A, int S = WS, int OFF = WOFF>
__device__ __forceinline__ void stage_routed(float* s,
                                             const float* __restrict__ q,
                                             const float* __restrict__ gi,
                                             int fi, int n, int hh, int jw,
                                             int i0) {
  for_region<ROWS, FTX + 2 * A>([&](int r, int cc) {
    const int c = cc - A;
    float* dst = s + r * S + OFF + c;
    const float* src = routed_src(q, gi, fi, n, hh, jw + r, i0 + c);
    if (src != nullptr)
      async_copy4(dst, src);
    else
      *dst = 0.0f;
  });
}

// Issues the copies of face f's window into w (no commit).
template <class R>
__device__ __forceinline__ void stage_window(const Params& p,
                                             StageWindowR<R>& w, int f,
                                             int j0, int i0) {
  constexpr int A = R::A;
  const int n = p.n, hh = p.halo, m = n + 2 * hh;
  const long mm = (long)m * m;
  const float* gi = p.gi + (long)f * (12 * hh + 4) * n;
  stage_routed<FTY + 2 * A, A, FTX + 2 * A, A>(
      &w.h[0][0], p.hc + block_of(0, f, mm), gi, 0, n, hh, j0 - A, i0);
  stage_routed<FTY + 2, 1>(&w.ua[0][0], p.uc + block_of(1, f, mm), gi, 1, n,
                           hh, j0 - 1, i0);
  stage_routed<FTY + 2, 1>(&w.ub[0][0], p.uc + block_of(2, f, mm), gi, 2, n,
                           hh, j0 - 1, i0);
  stage_band(w.b, p.b + f * mm, n, hh, j0, i0);
}

// One pass's ring cells of a thread: their inputs (the frame and y0 of
// the three fields), loaded before anything waits on them.
struct RingPass {
  float fr[2][3], y0[2][3];
  long cell[2];   // offset in the (m, m) block; -1: none
  int face[2];
};

// Issues the loads of the thread's ring cells k0 + t and k0 + t + NT.
__device__ __forceinline__ void ring_load(const Params& p,
                                          const FrameRing& g, int f0,
                                          int j0, int k0, RingPass& rp) {
  const int n = p.n, hh = p.halo, m = n + 2 * hh;
  const long mm = (long)m * m;
  const int t = threadIdx.y * BX + threadIdx.x;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    rp.cell[u] = -1;
    const int kf = k0 + t + u * NT;
    if (kf >= g.count) continue;
    int q, j, i;
    g.at(kf, n, hh, j0, q, j, i);
    const int f = f0 + q;
    const float* gi = p.gi + (long)f * (12 * hh + 4) * n;
    rp.face[u] = f;
    rp.cell[u] = (long)(j + hh) * m + i + hh;
#pragma unroll
    for (int fi = 0; fi < 3; ++fi) {
      const long blk = block_of(fi, f, mm);
      rp.fr[u][fi] = *routed_src((fi == 0 ? p.hc : p.uc) + blk, gi, fi, n,
                                 hh, j, i);
      rp.y0[u][fi] = p.with_y0 ? (fi == 0 ? p.h0 : p.u0)[blk + rp.cell[u]]
                               : 0.0f;
    }
  }
}

// Stores a*y0 + b*frame (stage 1: the frame) at the cells ring_load
// loaded.
__device__ __forceinline__ void ring_store(const Params& p,
                                           const RingPass& rp) {
  const int m = p.n + 2 * p.halo;
  const long mm = (long)m * m;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (rp.cell[u] < 0) continue;
#pragma unroll
    for (int fi = 0; fi < 3; ++fi)
      (fi == 0 ? p.ho : p.uo)[block_of(fi, rp.face[u], mm) + rp.cell[u]] =
          p.with_y0 ? p.a * rp.y0[u][fi] + p.bcoef * rp.fr[u][fi]
                    : rp.fr[u][fi];
  }
}

// The three faces of the block's group on one tile position, h's face
// states by policy R.
template <class R>
__device__ __forceinline__ void stage_faces(const Params& p, Smem<R>& sm,
                                            int f0, int j0, int i0) {
  // nr: the rows of a face's packed strips.
  const int n = p.n, hh = p.halo, m = n + 2 * hh, nr = 12 * hh;
  const long mm = (long)m * m;
  const int lx = threadIdx.x;
  const StageConsts k{p.R2, p.gravity, p.two_omega, p.inv2d, p.inv_d};
  // The tile holds cells of the boundary strips.
  const bool strips = j0 < hh || i0 < hh || j0 + FTY > n - hh
                      || i0 + FTX > n - hh;
  // The ring's first pass: its loads ahead of the first window's copies,
  // its stores after.
  const FrameRing ring(n, hh, j0, i0);
  RingPass rp;
  ring_load(p, ring, f0, j0, 0, rp);
  stage_window(p, sm.w[0], f0, j0, i0);
  async_commit();
  ring_store(p, rp);
  for (int k0 = 2 * NT; k0 < ring.count; k0 += 2 * NT) {   // small n, halo 3
    ring_load(p, ring, f0, j0, k0, rp);
    ring_store(p, rp);
  }
  stage_metric(sm.mt, p.xc, p.xf, p.xc, p.xf, p.R2, p.inv_d, n, hh, j0, i0);

  for (int q = 0; q < FPB; ++q) {
    const int f = f0 + q, cur = q & 1;
    if (q + 1 < FPB) {
      stage_window(p, sm.w[cur ^ 1], f + 1, j0, i0);
      async_commit();
    }
    // The combine's y0 at the thread's cells, loaded ahead of the
    // arithmetic.
    float y0[FTY / BY][3] = {};
    if (p.with_y0) {
#pragma unroll
      for (int r = 0; r < FTY / BY; ++r) {
        const int j = j0 + threadIdx.y + r * BY, i = i0 + lx;
        if (j < n && i < n) {
          const long c = (long)(j + hh) * m + i + hh;
          y0[r][0] = p.h0[block_of(0, f, mm) + c];
          y0[r][1] = p.u0[block_of(1, f, mm) + c];
          y0[r][2] = p.u0[block_of(2, f, mm) + c];
        }
      }
    }
    if (q + 1 < FPB)
      async_wait<1>();
    else
      async_wait<0>();
    __syncthreads();   // this face's window (and, first, mt) complete

    const StageWindowR<R>& w = sm.w[cur];
    const float* sym = p.gi + ((long)f * (nr + 4) + nr) * n;
    float* so = p.so + (long)f * nr * n;
    stage_face_tile<Seam::Frame>(
        w, sm.mt, sm.s, SymRows{sym, sym + n, sym + 2 * n, sym + 3 * n, 1},
        p.xc, p.xf, p.xc, p.xf, p.fz + 3 * f, k, n, hh, j0, i0,
        [&](int r, int j, int i, float dh, float dua, float dub, float hcv,
            float uav, float ubv) {
          const long c = (long)(j + hh) * m + i + hh;
          const float vals[3] = {
              combine(p.with_y0, p.a, p.bcoef, p.g_dt, y0[r][0], hcv, dh),
              combine(p.with_y0, p.a, p.bcoef, p.g_dt, y0[r][1], uav, dua),
              combine(p.with_y0, p.a, p.bcoef, p.g_dt, y0[r][2], ubv, dub)};
          p.ho[block_of(0, f, mm) + c] = vals[0];
          p.uo[block_of(1, f, mm) + c] = vals[1];
          p.uo[block_of(2, f, mm) + c] = vals[2];
          if (strips)
            for (int fi = 0; fi < 3; ++fi)
              put_packed(so, fi, n, hh, j, i, vals[fi]);
        });
    __syncthreads();   // w and the scratch are free for the next face
  }
}

template <class R>
__device__ __forceinline__ void stage_block(const Params& p) {
  extern __shared__ float smem_raw[];
  Smem<R>& sm = *reinterpret_cast<Smem<R>*>(smem_raw);
  stage_faces<R>(p, sm, blockIdx.z * FPB, blockIdx.y * FTY,
                 blockIdx.x * FTX);
}

#ifndef COV_INKERNEL_BF16
// One kernel per reconstruction; PLR-MC's keeps its name.
__global__ void __launch_bounds__(NT, 3)
cov_stage_inkernel_kernel(const Params p) {
  stage_block<PlrMc>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_stage_inkernel_kernel_none(const Params p) {
  stage_block<Plr<SlopeNone>>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_stage_inkernel_kernel_minmod(const Params p) {
  stage_block<Plr<SlopeMinmod>>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_stage_inkernel_kernel_mc_sign(const Params p) {
  stage_block<Plr<SlopeMcSign>>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_stage_inkernel_kernel_vanleer(const Params p) {
  stage_block<Plr<SlopeVanleer>>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_stage_inkernel_kernel_ppm(const Params p) {
  stage_block<Ppm>(p);
}
#else
// The bf16 compute policy (cov_stage_inkernel_bf16.cu): one kernel per
// PLR limiter, the limiter algebra and the flux face-average velocities
// in bfloat16 (PlrLo).
__global__ void __launch_bounds__(NT, 3)
cov_stage_inkernel_bf16_kernel_mc(const Params p) {
  stage_block<PlrLo<SlopeMcLo>>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_stage_inkernel_bf16_kernel_none(const Params p) {
  stage_block<PlrLo<SlopeNoneLo>>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_stage_inkernel_bf16_kernel_minmod(const Params p) {
  stage_block<PlrLo<SlopeMinmodLo>>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_stage_inkernel_bf16_kernel_mc_sign(const Params p) {
  stage_block<PlrLo<SlopeMcSignLo>>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_stage_inkernel_bf16_kernel_vanleer(const Params p) {
  stage_block<PlrLo<SlopeVanleerLo>>(p);
}
#endif

// Launches kernel (the instance of policy R) on `stream`.
template <class R>
int launch(void (*kernel)(Params), const Params& p, void* stream) {
  const int rc = dynamic_smem_limit<R>(kernel, sizeof(Smem<R>));
  if (rc != 0) return rc;
  const int n = p.n;
  const dim3 grid((n + FTX - 1) / FTX, (n + FTY - 1) / FTY, 6 / FPB);
  const dim3 block(BX, BY);
  const size_t smem = sizeof(Smem<R>);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch one stage on `stream`; each returns the cudaError_t of the shared
// memory attribute or of the launch (0 = ok).  with_y0 == 0: frame +
// g_dt*L (stage 1); with_y0 != 0: (a*y0 + b*frame) + g_dt*L (stages 2-3;
// h0/u0 read only then).  All tensors float32, contiguous, in the layouts
// of Params.  cov_stage_inkernel_f32 is PLR-MC,
// cov_stage_inkernel_<mode>_f32 the other reconstructions (PPM needs halo
// >= 3).
#define COV_INKERNEL_ENTRY(NAME, KERNEL, POLICY)                            \
  extern "C" int NAME(                                                      \
      const float* h0, const float* u0, const float* hc, const float* uc,   \
      const float* ghosts, const float* b_ext, const float* xc,             \
      const float* xf, const float* fz, float* ho, float* uo, float* so,    \
      int n, int halo, int with_y0, float R2, float gravity,                \
      float two_omega, float inv2d, float inv_d, float a, float b,          \
      float g_dt, void* stream) {                                           \
    const Params p{h0, u0, hc, uc, ghosts, b_ext, xc, xf, fz, ho, uo, so,   \
                   n, halo, with_y0, R2, gravity, two_omega, inv2d, inv_d,  \
                   a, b, g_dt};                                             \
    return launch<POLICY>(KERNEL, p, stream);                               \
  }

#ifndef COV_INKERNEL_BF16
COV_INKERNEL_ENTRY(cov_stage_inkernel_f32, cov_stage_inkernel_kernel, PlrMc)
COV_INKERNEL_ENTRY(cov_stage_inkernel_none_f32,
                   cov_stage_inkernel_kernel_none, Plr<SlopeNone>)
COV_INKERNEL_ENTRY(cov_stage_inkernel_minmod_f32,
                   cov_stage_inkernel_kernel_minmod, Plr<SlopeMinmod>)
COV_INKERNEL_ENTRY(cov_stage_inkernel_mc_sign_f32,
                   cov_stage_inkernel_kernel_mc_sign, Plr<SlopeMcSign>)
COV_INKERNEL_ENTRY(cov_stage_inkernel_vanleer_f32,
                   cov_stage_inkernel_kernel_vanleer, Plr<SlopeVanleer>)
COV_INKERNEL_ENTRY(cov_stage_inkernel_ppm_f32, cov_stage_inkernel_kernel_ppm,
                   Ppm)
#else
// The bf16 compute policy: cov_stage_inkernel_<mode>_bf16, PLR only.
COV_INKERNEL_ENTRY(cov_stage_inkernel_mc_bf16,
                   cov_stage_inkernel_bf16_kernel_mc, PlrLo<SlopeMcLo>)
COV_INKERNEL_ENTRY(cov_stage_inkernel_none_bf16,
                   cov_stage_inkernel_bf16_kernel_none, PlrLo<SlopeNoneLo>)
COV_INKERNEL_ENTRY(cov_stage_inkernel_minmod_bf16,
                   cov_stage_inkernel_bf16_kernel_minmod,
                   PlrLo<SlopeMinmodLo>)
COV_INKERNEL_ENTRY(cov_stage_inkernel_mc_sign_bf16,
                   cov_stage_inkernel_bf16_kernel_mc_sign,
                   PlrLo<SlopeMcSignLo>)
COV_INKERNEL_ENTRY(cov_stage_inkernel_vanleer_bf16,
                   cov_stage_inkernel_bf16_kernel_vanleer,
                   PlrLo<SlopeVanleerLo>)
#endif
