// The covariant shallow-water right-hand side of the extended blocks of a
// stack of ranks, each with its block's coordinates: the Hopper (sm_90a)
// kernel of the block-mesh tier's serialized form
// (jaxstream_torch/parallel/shard_cov_block.py), one launch per RK stage
// over every rank the process holds.
//
// Replaces the Pallas TPU kernel make_cov_rhs_pallas_local
// (jaxstream/ops/pallas/swe_cov.py:537, pallas_call at :610), which takes
// one block.  The plain PyTorch versions of the same function are
// jaxstream_torch.ops.cuda.swe_cov.cov_rhs_local_reference (one block) and
// cov_rhs_local_stacked_reference (the stack); the kernel reproduces their
// operations in their order (built with -fmad=false, so every multiply and
// add rounds separately, as PyTorch's do).
//
// What it computes, per rank r and cell (j, i) of the block's n x n
// interior: the covariant RHS (rhs_core_cov, sym_prescaled=False) of the
// extended block h (m, m), u_a, u_b, whose ghosts the tier's exchange
// filled, with the orography b (m, m), m = n + 2h.  The block covers its
// own patch of the face, so its gnomonic coordinates are operands: the tan
// of the cell centres and left faces along alpha, xr and xfr (1, m), and
// along beta, yc and yfc (m, 1), one set per group of ranks at the same
// block position.  The rank's sym strips sym_sn (2, n) / sym_we (n, 2) are
// imposed at all four block edges (the panel seams' symmetrized normals,
// the intra-panel seams' shared ones), times the edge sqrtg of the
// closed-form frame.  Out: dh (R, 1, n, n) and du (R, 2, 1, n, n).
//
// Bound.  Per rank it reads h, u_a, u_b and b (4 m^2 floats) and the sym
// rows (4 n), and writes 3 n^2, plus the group's coordinates (4 m): at
// C384 on the (6, 2, 2) mesh (24 ranks, n = 192, m = 196) that is 25.4 MB
// -> 7.6 us at 3.35 TB/s, against ~1.9 us of float32 arithmetic (~137
// flops per cell at 67 TFLOP/s): bound by memory.  One launch per rank,
// the earlier design, took ~10 us of launch latency for 0.32 us of bytes:
// 72 blocks on 132 SMs in one partial wave.
//
// Design: cov_faces.cuh's faces-in-block kernel (rhs_group<Seam::Frame>),
// as the compact stage's.  A block of 256 threads takes one 32 x 24 tile
// position and a group of up to three ranks at one block position (the
// group table), computes the tile's metric terms once from the group's
// rows into shared memory, and per rank stages the window (cp.async,
// double-buffered: the next rank's while this one computes) and runs the
// band, the fluxes and the tendencies, one tile column per lane.  At C384
// the 24 ranks make 8 groups: a grid of 6 x 8 x 8 = 384 blocks, one wave
// at 3 blocks per SM (72 576 B of dynamic shared memory,
// __launch_bounds__(256, 3)).
//
// Modes.  h's face states follow the launch's reconstruction, as B4's:
// one kernel and one C entry point per policy of cov_common.cuh
// (cov_rhs_local_<mode>_f32; PLR-MC keeps cov_rhs_local_kernel and
// cov_rhs_local_f32).  PPM stages h with a 3-deep apron (73 632 B, still
// 3 blocks per SM) and needs halo >= 3.

#include "cov_faces.cuh"

namespace {

using namespace cov;

// The launch's operands, as a type of this library's own: a function
// template's static of a type that two libraries share is one object
// across them (the dynamic loader unifies it), so dynamic_smem_limit's
// once-per-device flag would be set by whichever stacked kernel ran
// first and the other would launch without its shared memory attribute.
struct Params : RanksParams {};

template <class R>
__device__ __forceinline__ void local_block(const Params& p) {
  extern __shared__ float smem_raw[];
  RanksSmemR<R>& sm = *reinterpret_cast<RanksSmemR<R>*>(smem_raw);
  rhs_group<Seam::Frame, R>(p, sm, blockIdx.z, blockIdx.y * FTY,
                            blockIdx.x * FTX);
}

// One kernel per reconstruction; PLR-MC's keeps its name.
__global__ void __launch_bounds__(NT, 3)
cov_rhs_local_kernel(const Params p) {
  local_block<PlrMc>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_rhs_local_kernel_none(const Params p) {
  local_block<Plr<SlopeNone>>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_rhs_local_kernel_minmod(const Params p) {
  local_block<Plr<SlopeMinmod>>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_rhs_local_kernel_mc_sign(const Params p) {
  local_block<Plr<SlopeMcSign>>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_rhs_local_kernel_vanleer(const Params p) {
  local_block<Plr<SlopeVanleer>>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_rhs_local_kernel_ppm(const Params p) {
  local_block<Ppm>(p);
}

// Launches kernel (the instance of policy R) over ngroups groups.
template <class R>
int launch(void (*kernel)(Params), const Params& p, int ngroups,
           void* stream) {
  const int rc = dynamic_smem_limit<R>(kernel, sizeof(RanksSmemR<R>));
  if (rc != 0) return rc;
  const int n = p.n;
  const dim3 grid((n + FTX - 1) / FTX, (n + FTY - 1) / FTY, ngroups);
  const dim3 block(BX, BY);
  const size_t smem = sizeof(RanksSmemR<R>);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the stacked RHS of the ranks in ngroups groups on `stream`;
// returns the cudaError_t of the shared memory attribute or of the launch
// (0 = ok).  Tensors float32 (groups int32) in the layouts of
// cov::RanksParams; h, u and b with rank strides sh, su and sb, each
// rank's block contiguous.  cov_rhs_local_f32 is PLR-MC,
// cov_rhs_local_<mode>_f32 the other reconstructions (PPM needs halo >=
// 3).
#define COV_RHS_LOCAL_ENTRY(NAME, KERNEL, POLICY)                            \
  extern "C" int NAME(                                                      \
      const float* fz, const float* xr, const float* xfr, const float* yc,  \
      const float* yfc, const int* groups, const float* h_ext,              \
      const float* u_ext, const float* b_ext, const float* sym_sn,          \
      const float* sym_we, float* dh, float* du, long long sh,              \
      long long su, long long sb, int n, int halo, int ngroups, float R2,   \
      float gravity, float two_omega, float inv2d, float inv_d,             \
      void* stream) {                                                       \
    const Params p{{fz, xr, xfr, yc, yfc, groups, h_ext, u_ext, b_ext,      \
                    sym_sn, sym_we, dh, du, sh, su, sb, n, halo, R2,        \
                    gravity, two_omega, inv2d, inv_d}};                     \
    return launch<POLICY>(KERNEL, p, ngroups, stream);                      \
  }

COV_RHS_LOCAL_ENTRY(cov_rhs_local_f32, cov_rhs_local_kernel, PlrMc)
COV_RHS_LOCAL_ENTRY(cov_rhs_local_none_f32, cov_rhs_local_kernel_none,
                    Plr<SlopeNone>)
COV_RHS_LOCAL_ENTRY(cov_rhs_local_minmod_f32, cov_rhs_local_kernel_minmod,
                    Plr<SlopeMinmod>)
COV_RHS_LOCAL_ENTRY(cov_rhs_local_mc_sign_f32, cov_rhs_local_kernel_mc_sign,
                    Plr<SlopeMcSign>)
COV_RHS_LOCAL_ENTRY(cov_rhs_local_vanleer_f32, cov_rhs_local_kernel_vanleer,
                    Plr<SlopeVanleer>)
COV_RHS_LOCAL_ENTRY(cov_rhs_local_ppm_f32, cov_rhs_local_kernel_ppm, Ppm)
