// The covariant shallow-water right-hand side of the ghost-free cores of
// a stack of ranks: the Hopper (sm_90a) kernel that the overlapped
// sharded tiers (jaxstream_torch/parallel/shard_cov.py,
// shard_cov_block.py) run while the halo exchange is between its two
// phases, one launch per RK stage over every rank the process holds.
//
// Replaces the Pallas TPU kernel make_cov_rhs_interior_local
// (jaxstream/ops/pallas/swe_cov.py:659, pallas_call at :733), which takes
// one block.  The plain PyTorch versions of the same function are
// jaxstream_torch.ops.cuda.swe_cov.cov_rhs_interior_reference (one block)
// and cov_rhs_interior_stacked_reference (the stack); the kernel
// reproduces their operations in their order (built with -fmad=false, so
// every multiply and add rounds separately, as PyTorch's do).
//
// What it computes.  The halo depth h is the stencil radius of one RHS
// evaluation, so a cell at distance >= h from the block's boundary reads
// no ghost.  From each rank's interior fields h (n, n), u_a, u_b and
// orography b (n, n), with the interior coordinate windows xr, xfr (1, n)
// along alpha and yc, yfc (n, 1) along beta (one set per group of ranks
// at the same block position), it writes the tendencies of the ni x ni
// core, ni = n - 2h: dh (R, 1, ni, ni) and du (R, 2, 1, ni, ni).  The
// block's own outer h-ring is the stencil halo; no seam exists this deep
// inside, so no sym row is imposed.
//
// Bound.  Per rank it reads h, u_a, u_b and b (4 n^2 floats) and writes
// 3 ni^2, plus the group's coordinates (4 n): at C384 that is 24.6 MB ->
// 7.3 us at 3.35 TB/s over the face tier's 6 ranks (n = 384, ni = 380)
// and 24.4 MB -> 7.3 us over the (6, 2, 2) mesh's 24 (n = 192, ni = 188),
// against ~1.8 us of float32 arithmetic (~137 flops per cell at 67
// TFLOP/s): bound by memory.  One launch per rank, the earlier design,
// took 10-12 us of launch latency for 0.30-1.22 us of bytes.
//
// Design: cov_faces.cuh's faces-in-block kernel with its seams off
// (rhs_group<Seam::None>): the interior field is read as the extended
// array of an ni x ni "face" (its m = ni + 2h is the block's n).  A block
// of 256 threads takes one 32 x 24 tile position of the core and a group
// of up to three ranks at one block position, computes the tile's metric
// terms once, and per rank stages the window (cp.async, double-buffered)
// and computes, one tile column per lane.  At C384: 12 x 16 x 2 = 384
// blocks on the face tier, 6 x 8 x 8 = 384 on the block tier, one wave at
// 3 blocks per SM (72 576 B of dynamic shared memory,
// __launch_bounds__(256, 3)).

#include "cov_faces.cuh"

namespace {

using namespace cov;

// The launch's operands, as a type of this library's own: a function
// template's static of a type that two libraries share is one object
// across them (the dynamic loader unifies it), so dynamic_smem_limit's
// once-per-device flag would be set by whichever stacked kernel ran
// first and the other would launch without its shared memory attribute.
struct Params : RanksParams {};

__global__ void __launch_bounds__(NT, 3)
cov_rhs_interior_kernel(const Params p) {
  extern __shared__ float smem_raw[];
  RanksSmem& sm = *reinterpret_cast<RanksSmem*>(smem_raw);
  rhs_group<Seam::None>(p, sm, blockIdx.z, blockIdx.y * FTY,
                         blockIdx.x * FTX);
}

}  // namespace

// Launches the stacked core RHS of the ranks in ngroups groups on
// `stream`; returns the cudaError_t of the shared memory attribute or of
// the launch (0 = ok).  Tensors float32 (groups int32) in the layouts of
// cov::RanksParams with n = ni = the block's n - 2 halo > 0; h, u and b
// with rank strides sh, su and sb, each rank's block contiguous.
extern "C" int cov_rhs_interior_f32(
    const float* fz, const float* xr, const float* xfr, const float* yc,
    const float* yfc, const int* groups, const float* h_int,
    const float* u_int, const float* b_int, float* dh, float* du,
    long long sh, long long su, long long sb, int ni, int halo, int ngroups,
    float R2, float gravity, float two_omega, float inv2d, float inv_d,
    void* stream) {
  const Params p{{fz, xr, xfr, yc, yfc, groups, h_int, u_int,
                  b_int, nullptr, nullptr, dh, du, sh, su, sb, ni,
                  halo, R2, gravity, two_omega, inv2d, inv_d}};
  const int rc =
      dynamic_smem_limit(cov_rhs_interior_kernel, sizeof(RanksSmem));
  if (rc != 0) return rc;
  const dim3 grid((ni + FTX - 1) / FTX, (ni + FTY - 1) / FTY, ngroups);
  const dim3 block(BX, BY);
  const size_t smem = sizeof(RanksSmem);
  cov_rhs_interior_kernel<<<grid, block, smem,
      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
