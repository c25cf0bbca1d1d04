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
// mass flux through sqrtg a^i at the faces (h's face states by the
// launch's reconstruction: PLR with one of the five limiters, or PPM at
// halo >= 3), the vorticity from the
// covariant components v . e_i on the band, the Bernoulli gradient, the
// Coriolis term and the tangent projection.  Out: dh (6, n, n) and dv
// (3, 6, n, n); the RK combine is the stepper's.
//
// Bound.  It reads h, v (3 components) and b (5 x 6 m^2 floats) and
// writes 4 x 6 n^2: at C384 (m = 388) 32.22 MB -> 9.62 us at 3.35 TB/s.
// The float32 arithmetic (~470 flops per cell: the general basis is
// evaluated four times per cell, with an rsqrtf at each and an IEEE
// division at the x-face, the y-face and twice at the centre) is ~6 us at
// 67 TFLOP/s: bound by memory, but the closest of the Cartesian kernels
// to its arithmetic.  A launch's bytes fit the 50 MB L2, so what a
// tile-per-block kernel spends instead is latency and instructions.
//
// Design.  swe_stage.cu's (B10's) faces-in-block body without the ring
// and the combine: a block of 256 threads takes one 32 x 24 tile position
// and a group of three faces (swe_faces.cuh), a grid of (ceil(n/32),
// ceil(n/24), 2), 12 x 16 x 2 = 384 blocks at C384.  The block
//   1. issues the asynchronous copies (cp.async) of its first face's
//      window: h with the reconstruction's apron (2 deep for PLR, 3 for
//      PPM), v0, v1, v2 with a 1-deep one, b on the Bernoulli band,
//      straight from the extended frames (0 past them);
//   2. meanwhile computes the general basis's IEEE divisions, which do not
//      read the face frame, once for the group's three faces into shared
//      memory (SweBasis: 1/det g at the x-faces, y-faces and centres,
//      1/sqrtg at the centres), and loads the three face frames;
//   3. per face of its group: issues the next face's window into the
//      other buffer, waits for this face's window, runs
//      swe_face_tile<false> (rhs_core) with the divisions from the table,
//      and stores dh and dv at the tile's interior cells.
// Occupancy: 67 196 B of dynamic shared memory (two windows 2 x 18 800,
// basis 12 512, scratch 16 976, frames 108; PPM's 3-deep h apron adds
// 2 x 528) and __launch_bounds__(256, 3): 3 blocks (24 warps) per SM,
// <= 80 registers.  384 blocks on 132 SMs x 3 slots = 396: one wave.
//
// Modes.  The body is a template on the face-state policy of
// cov_common.cuh; each of the six reconstructions is its own kernel and
// its own C entry point (swe_rhs_<mode>_f32; PLR-MC keeps the kernel
// swe_rhs_kernel and the entry swe_rhs_f32).

#include "swe_faces.cuh"

namespace {

using namespace cov;
using namespace swe;

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

template <class R>
struct Smem {
  SweWindowR<R> w[2];   // this face's window and the next one's
  SweBasis bt;
  SweScratch s;
  float fr[FPB][9];   // the group's face frames
};

// The three faces of the block's group on one tile position, h's face
// states by policy R.
template <class R>
__device__ __forceinline__ void rhs_faces(const Params& p, Smem<R>& sm,
                                          int f0, int j0, int i0) {
  const int n = p.n, hh = p.halo;
  const long nn = (long)n * n;
  stage_frame_window(sm.w[0], p.h, p.v, p.b, f0, n, hh, j0, i0);
  async_commit();
  swe_basis(sm.bt, p.xc, p.xf, p.k, n, hh, j0, i0);
  {
    const int t = threadIdx.y * BX + threadIdx.x;
    if (t < FPB * 9) sm.fr[t / 9][t % 9] = p.frames[9 * f0 + t];
  }

  for (int q = 0; q < FPB; ++q) {
    const int f = f0 + q, cur = q & 1;
    if (q + 1 < FPB) {
      stage_frame_window(sm.w[cur ^ 1], p.h, p.v, p.b, f + 1, n, hh, j0, i0);
      async_commit();
      async_wait<1>();
    } else {
      async_wait<0>();
    }
    __syncthreads();   // this face's window (and, first, bt) complete

    swe_face_tile<false>(
        sm.w[cur], sm.bt, sm.s, sm.fr[q], p.xc, p.xf, p.k, n, hh, j0, i0,
        [&](int, int, int, int j, int i, float dh, float dv0, float dv1,
            float dv2) {
          const long c = f * nn + (long)j * n + i;
          p.dh[c] = dh;
          p.dv[c] = dv0;
          p.dv[6 * nn + c] = dv1;
          p.dv[12 * nn + c] = dv2;
        });
    __syncthreads();   // the window and the scratch are free for the next face
  }
}

template <class R>
__device__ __forceinline__ void rhs_block(const Params& p) {
  extern __shared__ float smem_raw[];
  Smem<R>& sm = *reinterpret_cast<Smem<R>*>(smem_raw);
  rhs_faces<R>(p, sm, blockIdx.z * FPB, blockIdx.y * FTY, blockIdx.x * FTX);
}

// One kernel per reconstruction; PLR-MC's keeps its name.
__global__ void __launch_bounds__(NT, 3) swe_rhs_kernel(const Params p) {
  rhs_block<PlrMc>(p);
}
__global__ void __launch_bounds__(NT, 3) swe_rhs_kernel_none(const Params p) {
  rhs_block<Plr<SlopeNone>>(p);
}
__global__ void __launch_bounds__(NT, 3) swe_rhs_kernel_minmod(
    const Params p) {
  rhs_block<Plr<SlopeMinmod>>(p);
}
__global__ void __launch_bounds__(NT, 3) swe_rhs_kernel_mc_sign(
    const Params p) {
  rhs_block<Plr<SlopeMcSign>>(p);
}
__global__ void __launch_bounds__(NT, 3) swe_rhs_kernel_vanleer(
    const Params p) {
  rhs_block<Plr<SlopeVanleer>>(p);
}
__global__ void __launch_bounds__(NT, 3) swe_rhs_kernel_ppm(const Params p) {
  rhs_block<Ppm>(p);
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

// Launch the RHS on `stream`; each returns the cudaError_t of the shared
// memory attribute or of the launch (0 = ok).  All tensors float32,
// contiguous, in the layouts of Params.  swe_rhs_f32 is PLR-MC,
// swe_rhs_<mode>_f32 the other reconstructions (PPM needs halo >= 3).
#define SWE_RHS_ENTRY(NAME, KERNEL, POLICY)                                 \
  extern "C" int NAME(                                                      \
      const float* frames, const float* h_ext, const float* v_ext,          \
      const float* b_ext, const float* xc, const float* xf, float* dh,      \
      float* dv, int n, int halo, float R, float R2, float gravity,         \
      float two_omega, float inv2d, float inv_d, void* stream) {            \
    const Params p{frames, h_ext, v_ext, b_ext, xc, xf, dh, dv, n, halo,    \
                   Consts{R, R2, gravity, two_omega, inv2d, inv_d}};        \
    return launch<POLICY>(KERNEL, p, stream);                               \
  }

SWE_RHS_ENTRY(swe_rhs_f32, swe_rhs_kernel, PlrMc)
SWE_RHS_ENTRY(swe_rhs_none_f32, swe_rhs_kernel_none, Plr<SlopeNone>)
SWE_RHS_ENTRY(swe_rhs_minmod_f32, swe_rhs_kernel_minmod, Plr<SlopeMinmod>)
SWE_RHS_ENTRY(swe_rhs_mc_sign_f32, swe_rhs_kernel_mc_sign, Plr<SlopeMcSign>)
SWE_RHS_ENTRY(swe_rhs_vanleer_f32, swe_rhs_kernel_vanleer, Plr<SlopeVanleer>)
SWE_RHS_ENTRY(swe_rhs_ppm_f32, swe_rhs_kernel_ppm, Ppm)
