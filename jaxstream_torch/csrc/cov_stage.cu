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
//   dh       -(1/(sqrtg d)) [flux differences], upwind h times the
//            sqrtg-folded contravariant face velocity, h's face states by
//            the launch's reconstruction: PLR with one of the five
//            limiters, or PPM (halo >= 3).
//   du       vector-invariant momentum: (zeta + f) sqrtg u^perp minus the
//            centered gradient of g (h + b) + K; metrics in closed form
//            from X = tan(alpha), Y = tan(beta) (no metric arrays read).
//   y_new    stage 1: yc + g*dt*L; stages 2-3: (a*y0 + b*yc) + b*dt*L;
//            written with the new boundary strips (6, 6h, n) / (6, n, 6h).
//
// Bound.  With ~137 flops per cell per stage (jaxstream/utils/
// profiling.py:136) the stage does 6 n^2 * 137 flops; it moves 7 field
// passes of 6 n^2 float32 (stage 1: h, u_a, u_b in and out plus b) or 10
// (stages 2-3: plus y0), and the strips.  At C384 that is ~24.8 MB ->
// 7.4 us (stage 1) and ~35.4 MB -> 10.6 us (stages 2-3) at 3.35 TB/s,
// against ~1.8 us of float32 arithmetic at 67 TFLOP/s: bound by memory.
// A launch's bytes fit the 50 MB L2, so what a tile-per-block kernel
// spends instead is latency and instructions: loads that nothing
// overlaps, and the closed-form metric (IEEE divisions, rsqrtf) rebuilt
// for each face of a tile position though it is the same on all six.
//
// Design.  A block of 256 threads takes one 32 x 24 tile position and a
// group of three faces (cov_faces.cuh): the grid is (ceil(n/32),
// ceil(n/24), 2), 12 x 16 x 2 = 384 blocks at C384.  The block
//   1. issues the asynchronous copies (cp.async) of its first face's
//      window: h with the reconstruction's apron (2 deep for PLR, 3 for
//      PPM), u_a and u_b with a 1-deep one (each
//      cell from the interior or, past the face edge, the routed strips;
//      ghost corners, which no kept output reads, and cells past a ragged
//      tile as zeros), b on the Bernoulli band;
//   2. meanwhile computes the tile's face-independent metric terms once
//      into shared memory (StageMetric: g_aa, g_ab, g_bb on the band, the
//      xface/yface_metric pairs, sqrtg, inv_sqrtg/d and inv_rho at the
//      centers): the very floats rhs_core_cov computes for each face;
//   3. per face of its group: issues the next face's window into the
//      other buffer, waits for this face's, and runs the band, the fluxes
//      and the tendencies from shared memory; the epilogue's y0 loads are
//      issued at the top of the face's step, so they land under its
//      arithmetic.
// Every per-cell phase maps one tile column to one lane (for_region), so
// a thread's cells sit at offsets known at compile time: the kernel is
// bound by instruction issue, most of it integer index and mask work
// (the SASS of the first faces-in-block build was ~70% integer and
// control instructions).  One code path serves every tile: an
// instantiation for tiles whose window lies inside the face (no masks,
// 16-byte copies) was measured slower on the H100, its larger code and
// register pressure costing more than the masks it saved.
// Occupancy: 72 576 B of dynamic shared memory (two windows 2 x 15 056,
// metric 32 560, scratch 9 904; PPM's 3-deep h apron adds 2 x 528) and
// __launch_bounds__(256, 3): 3 blocks (24 warps) per SM, <= 80
// registers.  384 blocks on 132 SMs x 3 slots = 396: one wave, 120 SMs
// with three blocks and 12 with two.
//
// Modes.  The body is a template on the face-state policy of
// cov_common.cuh; each of the six reconstructions is its own kernel and
// its own C entry point (cov_stage_compact_<mode>_f32; PLR-MC keeps the
// kernel cov_stage_kernel and the entry cov_stage_compact_f32).

#include "cov_faces.cuh"

namespace {

using namespace cov;

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

template <class R>
struct Smem {
  StageWindowR<R> w[2];   // this face's window and the next one's
  StageMetric mt;
  StageScratch s;
};

// The three faces of the block's group on one tile position, h's face
// states by policy R.
template <class R>
__device__ __forceinline__ void stage_faces(const Params& p, Smem<R>& sm,
                                            int f0, int j0, int i0) {
  const int n = p.n, hh = p.halo, rw = 6 * hh + 2;
  const long nn = (long)n * n;
  const int lx = threadIdx.x;
  const StageConsts k{p.R2, p.gravity, p.two_omega, p.inv2d, p.inv_d};
  // The tile holds cells of the boundary strips.
  const bool strips = j0 < hh || i0 < hh || j0 + FTY > n - hh
                      || i0 + FTX > n - hh;

  stage_compact_window(p, sm.w[0], f0, j0, i0);
  async_commit();
  stage_metric(sm.mt, p.xc, p.xf, p.xc, p.xf, p.R2, p.inv_d, n, hh, j0, i0);

  for (int q = 0; q < FPB; ++q) {
    const int f = f0 + q, cur = q & 1;
    if (q + 1 < FPB) {
      stage_compact_window(p, sm.w[cur ^ 1], f + 1, j0, i0);
      async_commit();
      async_wait<1>();
    } else {
      async_wait<0>();
    }
    // The combine's y0 at the thread's cells, loaded ahead of the
    // arithmetic.
    float y0[FTY / BY][3] = {};
    if (p.with_y0) {
#pragma unroll
      for (int r = 0; r < FTY / BY; ++r) {
        const int j = j0 + threadIdx.y + r * BY, i = i0 + lx;
        if (j < n && i < n) {
          const long c = f * nn + (long)j * n + i;
          y0[r][0] = p.h0[c];
          y0[r][1] = p.u0[c];
          y0[r][2] = p.u0[6 * nn + c];
        }
      }
    }
    __syncthreads();   // this face's window (and, first, mt) complete

    const StageWindowR<R>& w = sm.w[cur];
    const float* gsn = p.gsn + (long)f * rw * n;
    const float* gwe = p.gwe + (long)f * n * rw;
    float* ssn = p.ssn + (long)f * 6 * hh * n;
    float* swe = p.swe + (long)f * n * 6 * hh;
    stage_face_tile<Seam::Prescaled>(
        w, sm.mt, sm.s, routed_sym(gsn, gwe, n, hh), p.xc, p.xf, p.xc,
        p.xf, p.fz + 3 * f, k, n, hh, j0, i0,
        [&](int r, int j, int i, float dh, float dua, float dub, float hcv,
            float uav, float ubv) {
          const long c = f * nn + (long)j * n + i;
          const float vals[3] = {
              combine(p.with_y0, p.a, p.bcoef, p.g_dt, y0[r][0], hcv, dh),
              combine(p.with_y0, p.a, p.bcoef, p.g_dt, y0[r][1], uav, dua),
              combine(p.with_y0, p.a, p.bcoef, p.g_dt, y0[r][2], ubv, dub)};
          p.ho[c] = vals[0];
          p.uo[c] = vals[1];
          p.uo[6 * nn + c] = vals[2];
          if (strips)
            for (int fi = 0; fi < 3; ++fi)
              put_strips(ssn, swe, fi, n, hh, j, i, vals[fi]);
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

// One kernel per reconstruction; PLR-MC's keeps its name.
__global__ void __launch_bounds__(NT, 3) cov_stage_kernel(const Params p) {
  stage_block<PlrMc>(p);
}
__global__ void __launch_bounds__(NT, 3) cov_stage_kernel_none(
    const Params p) {
  stage_block<Plr<SlopeNone>>(p);
}
__global__ void __launch_bounds__(NT, 3) cov_stage_kernel_minmod(
    const Params p) {
  stage_block<Plr<SlopeMinmod>>(p);
}
__global__ void __launch_bounds__(NT, 3) cov_stage_kernel_mc_sign(
    const Params p) {
  stage_block<Plr<SlopeMcSign>>(p);
}
__global__ void __launch_bounds__(NT, 3) cov_stage_kernel_vanleer(
    const Params p) {
  stage_block<Plr<SlopeVanleer>>(p);
}
__global__ void __launch_bounds__(NT, 3) cov_stage_kernel_ppm(
    const Params p) {
  stage_block<Ppm>(p);
}

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
// memory attribute or of the launch (0 = ok).  with_y0 == 0: yc +
// g_dt*L (stage 1); with_y0 != 0: (a*y0 + b*yc) + g_dt*L (stages 2-3;
// h0/u0 read only then).  All tensors float32, contiguous, in the layouts
// of Params.  cov_stage_compact_f32 is PLR-MC, cov_stage_compact_<mode>_f32
// the other reconstructions (PPM needs halo >= 3).
#define COV_STAGE_ENTRY(NAME, KERNEL, POLICY)                               \
  extern "C" int NAME(                                                      \
      const float* h0, const float* u0, const float* hc, const float* uc,   \
      const float* gsn, const float* gwe, const float* b_ext,               \
      const float* xc, const float* xf, const float* fz, float* ho,         \
      float* uo, float* ssn, float* swe, int n, int halo, int with_y0,      \
      float R2, float gravity, float two_omega, float inv2d, float inv_d,   \
      float a, float b, float g_dt, void* stream) {                         \
    const Params p{h0, u0, hc, uc, gsn, gwe, b_ext, xc, xf, fz, ho, uo,     \
                   ssn, swe, n, halo, with_y0, R2, gravity, two_omega,      \
                   inv2d, inv_d, a, b, g_dt};                               \
    return launch<POLICY>(KERNEL, p, stream);                               \
  }

COV_STAGE_ENTRY(cov_stage_compact_f32, cov_stage_kernel, PlrMc)
COV_STAGE_ENTRY(cov_stage_compact_none_f32, cov_stage_kernel_none,
                Plr<SlopeNone>)
COV_STAGE_ENTRY(cov_stage_compact_minmod_f32, cov_stage_kernel_minmod,
                Plr<SlopeMinmod>)
COV_STAGE_ENTRY(cov_stage_compact_mc_sign_f32, cov_stage_kernel_mc_sign,
                Plr<SlopeMcSign>)
COV_STAGE_ENTRY(cov_stage_compact_vanleer_f32, cov_stage_kernel_vanleer,
                Plr<SlopeVanleer>)
COV_STAGE_ENTRY(cov_stage_compact_ppm_f32, cov_stage_kernel_ppm, Ppm)
