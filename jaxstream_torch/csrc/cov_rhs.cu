// The covariant shallow-water right-hand side of ghost-filled extended
// faces: the Hopper (sm_90a) kernel of jaxstream_torch's classic path
// under backend='pallas' and of the face tier's serialized form.
//
// Replaces the Pallas TPU kernel make_cov_rhs_pallas
// (jaxstream/ops/pallas/swe_cov.py:429, pallas_call at :508).  The plain
// PyTorch versions of the same function are
// jaxstream_torch.ops.cuda.swe_cov.cov_rhs_reference (F faces in the
// classic layout) and, for a stack of faces, the block RHS's
// cov_rhs_local_stacked_reference with the full-face rows; the kernel
// reproduces their operations in their order (built with -fmad=false, so
// every multiply and add rounds separately, as PyTorch's do).
//
// What it computes, per face r and interior cell (j, i): the covariant RHS
// (rhs_core_cov, sym_prescaled=False) of the extended frames h (m, m),
// u_a, u_b, whose ghosts the caller's halo exchange filled, with the
// orography b (m, m), m = n + 2h.  The symmetrized edge normals sym_sn
// (2, n) / sym_we (n, 2) are multiplied by the edge sqrtg of the
// closed-form frame and imposed on the boundary fluxes.  Out: the
// tendencies dh and du_a, du_b; the RK combine is the stepper's.  Three
// layouts, one kernel (strides are operands):
//   six faces (classic)  h (F, m, m), u (2, F, m, m) -> dh (F, n, n), du
//                        (2, F, n, n): u_b F m^2 after u_a, du_b F n^2
//                        after du_a;
//   one face             the same with F = 1 (the JAX signature, n_faces=1,
//                        external_sym=True);
//   stacked (face tier)  views of the tier's q (R, 3, m, m): rank stride
//                        3 m^2, u_b m^2 after u_a -> dh (R, 1, n, n), du
//                        (R, 2, 1, n, n), the tier's own layout.
//
// Bound.  It reads h, u_a, u_b and b (4 m^2 floats per face) and the sym
// rows (4 n), and writes 3 n^2: at C384 over six faces (m = 388) 25.11 MB
// -> 7.49 us at 3.35 TB/s, against ~1.8 us of float32 arithmetic at 67
// TFLOP/s (~137 flops per cell): bound by memory.  The first design (one
// 32 x 16 tile of one face per block, synchronous apron loads, the metric
// per face) took 49.34 us over six faces and, on the face tier, 12.95 us
// per one-face launch: 6 launches of 288 blocks per RK stage, each a
// partial wave on 132 SMs.
//
// Design: cov_faces.cuh's faces-in-block body, as B6's rhs_group<Frame>
// with the face's own coordinate rows.  A block of 256 threads takes one
// 32 x 24 tile position and a group of up to three faces (the group
// table; every group of whole faces shares the full-face rows, passed once
// per group), computes the tile's metric terms once into shared memory,
// and per face stages the window (cp.async, double-buffered: the next
// face's while this one computes) and runs the band, the fluxes and the
// tendencies, one tile column per lane.  Six faces make 2 groups of 3: a
// grid of 12 x 16 x 2 = 384 blocks at C384, one wave at 3 blocks per SM
// (72 576 B of dynamic shared memory, __launch_bounds__(256, 3)); the face
// tier's serialized form launches it once per RK stage over its six
// faces.  Its inputs are never written in the launch, so they take
// cp.async.ca like B6's.

#include "cov_faces.cuh"

namespace {

using namespace cov;

// The launch's operands (a type of this library's own: cov_rhs_local.cu
// says why).  Face r's fields sit at r times the rank strides; a field's
// second component (u_b, du_b) at the component stride after its first.
struct Params {
  const float* fz;      // face r's (c0, cx, cy) at fz + 3 r
  const float* xr;      // (G, 1, m) tan of the cell-centre alphas
  const float* xfr;     // (G, 1, m) tan of the left-face alphas
  const float* yc;      // (G, m, 1) tan of the cell-centre betas
  const float* yfc;     // (G, m, 1) tan of the lower-face betas
  const int* groups;    // (G, FPB) the group's faces, then -1
  const float* h;       // face r's (m, m) frame at h + r * sh
  const float* u;       // face r's u_a at u + r * su, u_b cu after it
  const float* b;       // face r's (m, m) orography at b + r * sb
  const float* sym_sn;  // face r's S, N normals (2, n) at sym_sn + 2 n r
  const float* sym_we;  // face r's W, E normals (n, 2) at sym_we + 2 n r
  float* dh;            // face r's (n, n) at dh + r * sdh
  float* du;            // face r's du_a at du + r * sdu, du_b cdu after it
  long long sh, su, cu, sb, sdh, sdu, cdu;
  int n, halo;
  float R2, gravity, two_omega, inv2d, inv_d;
};

// Issues the copies of face r's window into w (no commit).
__device__ __forceinline__ void stage_face_window(const Params& p,
                                                  StageWindow& w, int r,
                                                  int j0, int i0) {
  const int n = p.n, hh = p.halo;
  const float* ua = p.u + r * p.su;
  const float* ub = ua + p.cu;
  stage_frame<FTY + 4, 2>(&w.h[0][0], p.h + r * p.sh, n, hh, j0 - 2, i0);
  stage_frame<FTY + 2, 1>(&w.ua[0][0], ua, n, hh, j0 - 1, i0);
  stage_frame<FTY + 2, 1>(&w.ub[0][0], ub, n, hh, j0 - 1, i0);
  stage_band(w.b, p.b + r * p.sb, n, hh, j0, i0);
}

// The faces of group g on the tile at (j0, i0): the group's metric terms
// once, then each face's tile from its window while the next face's is
// staged.
__device__ __forceinline__ void rhs_faces(const Params& p, RanksSmem& sm,
                                          int g, int j0, int i0) {
  const int n = p.n, hh = p.halo, m = n + 2 * hh;
  const StageConsts k{p.R2, p.gravity, p.two_omega, p.inv2d, p.inv_d};
  const int* faces = p.groups + g * FPB;
  const long rows = (long)g * m;   // the group's coordinate rows
  const float* xr = p.xr + rows;
  const float* xfr = p.xfr + rows;
  const float* yc = p.yc + rows;
  const float* yfc = p.yfc + rows;

  stage_face_window(p, sm.w[0], faces[0], j0, i0);
  async_commit();
  stage_metric(sm.mt, xr, xfr, yc, yfc, p.R2, p.inv_d, n, hh, j0, i0);

  for (int q = 0; q < FPB; ++q) {
    const int r = faces[q];
    if (r < 0) break;
    const int cur = q & 1;
    const int next = q + 1 < FPB ? faces[q + 1] : -1;
    if (next >= 0) {
      stage_face_window(p, sm.w[cur ^ 1], next, j0, i0);
      async_commit();
      async_wait<1>();
    } else {
      async_wait<0>();
    }
    __syncthreads();   // this face's window (and, first, mt) complete

    const float* sn = p.sym_sn + 2L * r * n;
    const float* we = p.sym_we + 2L * r * n;
    float* dh = p.dh + r * p.sdh;
    float* dua = p.du + r * p.sdu;
    float* dub = dua + p.cdu;
    stage_face_tile<Seam::Frame>(
        sm.w[cur], sm.mt, sm.s, SymRows{sn, sn + n, we, we + 1, 2}, xr, xfr,
        yc, yfc, p.fz + 3 * r, k, n, hh, j0, i0,
        [&](int, int j, int i, float dhv, float duav, float dubv, float,
            float, float) {
          const long c = (long)j * n + i;
          dh[c] = dhv;
          dua[c] = duav;
          dub[c] = dubv;
        });
    __syncthreads();   // w and the scratch are free for the next face
  }
}

__global__ void __launch_bounds__(NT, 3) cov_rhs_kernel(const Params p) {
  extern __shared__ float smem_raw[];
  RanksSmem& sm = *reinterpret_cast<RanksSmem*>(smem_raw);
  rhs_faces(p, sm, blockIdx.z, blockIdx.y * FTY, blockIdx.x * FTX);
}

}  // namespace

// Launches the RHS of the faces in ngroups groups on `stream`; returns the
// cudaError_t of the shared memory attribute or of the launch (0 = ok).
// Tensors float32 (groups int32) in the layouts of Params, each face's
// (m, m) frames and (n, n) outputs contiguous.
extern "C" int cov_rhs_f32(
    const float* fz, const float* xr, const float* xfr, const float* yc,
    const float* yfc, const int* groups, const float* h_ext,
    const float* u_ext, const float* b_ext, const float* sym_sn,
    const float* sym_we, float* dh, float* du, long long sh, long long su,
    long long cu, long long sb, long long sdh, long long sdu, long long cdu,
    int n, int halo, int ngroups, float R2, float gravity, float two_omega,
    float inv2d, float inv_d, void* stream) {
  const Params p{fz, xr, xfr, yc, yfc, groups, h_ext, u_ext, b_ext, sym_sn,
                 sym_we, dh, du, sh, su, cu, sb, sdh, sdu, cdu, n, halo,
                 R2, gravity, two_omega, inv2d, inv_d};
  const int rc = dynamic_smem_limit(cov_rhs_kernel, sizeof(RanksSmem));
  if (rc != 0) return rc;
  const dim3 grid((n + FTX - 1) / FTX, (n + FTY - 1) / FTY, ngroups);
  const dim3 block(BX, BY);
  const size_t smem = sizeof(RanksSmem);
  cov_rhs_kernel<<<grid, block, smem,
                   static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
