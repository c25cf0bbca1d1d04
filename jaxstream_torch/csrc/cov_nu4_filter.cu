// The once-per-step del^4 filter of the covariant shallow-water equations
// on the cubed sphere: the Hopper (sm_90a) kernel of jaxstream_torch.
//
// Replaces the Pallas TPU kernel make_cov_nu4_filter
// (jaxstream/ops/pallas/swe_cov.py:2474, pallas_call at :2544).  The plain
// PyTorch version of the same function is
// jaxstream_torch.ops.cuda.swe_cov.cov_nu4_filter_reference (lap_core,
// _nu4_filtered_value, _fill(corners=True)); the kernel reproduces its
// operations in its order (built with -fmad=false, so every multiply and
// add rounds separately, as PyTorch's do).
//
// What it computes, per face f, field q in (h, u_a, u_b) and interior
// cell (j, i):
//   psi   q extended by the routed ghosts gsn (6, 6h+2, n) / gwe
//         (6, n, 6h+2), field fi at rows/columns fi*2h .. fi*2h+2h
//         (S|N, W|E); each h x h ghost corner is the edge-ghost average
//         0.5 (S/N ghost at the first/last interior column + W/E ghost at
//         the first/last interior row).  The sym rows are not read.
//   l1    lap(psi) on the ring-1 window [-1, n]^2: on the ghost ring it
//         is the face-local operator at the ghost positions (the JAX
//         design, so the second Laplacian needs no exchange).
//   l2    lap(l1) on the interior.
//   q'    q - damp l2, damp = f32(dt_eff nu4); written with the new
//         boundary strips (6, 6h, n) / (6, n, 6h).
// lap is the conservative flux form: face fluxes fg_aa d_a + fg_ab d_b
// (x-faces) and fg_bb d_b + fg_ab d_a (y-faces), the cross derivative
// averaged from the centered derivatives of the two abutting cells, and
// the flux difference times inv_sqrtg / d.
//
// Design.  The TPU kernel fills a whole (m, m) face of each field in
// VMEM.  Here each block takes one 32 x 16 output tile of one face: a
// grid of (ceil(n/32), ceil(n/16), 6) independent blocks with no atomics,
// so the result is bitwise reproducible.  A block stages psi of the three
// fields over the tile plus a 2-deep apron with its corners (the second
// Laplacian's cross terms read l1's ring-1 diagonal cells, built from
// psi's diagonal neighbours), computes l1 of the three fields on the
// (TY+2) x (TX+2) window into shared memory, then l2 on the tile.  The
// closed-form metric terms (_fast_frame) do not depend on the field:
// they are evaluated once per face and cell of the window into shared
// memory and serve both Laplacians of all three fields.  28.6 KB of
// shared memory per block.
//
// Bound.  The filter reads h, u (10.6 MB at C384) and the ghost blocks
// (0.26 MB) and writes h, u (10.6 MB) and the strips (0.22 MB): ~21.7 MB,
// 6.5 us at 3.35 TB/s.  Its arithmetic is 169 flops per cell (22 per
// Laplacian per field, 2 for the damp per field, 31 for the shared metric
// terms), ~0.15 GFLOP at C384, 2.2 us at 67 TFLOP/s: bound by memory.
// This first design is simple and right; TMA / cp.async staging and
// occupancy tuning are for later.

#include "cov_common.cuh"

namespace {

using namespace cov;

struct Params {
  const float* hc;   // (6, n, n)
  const float* uc;   // (2, 6, n, n)
  const float* gsn;  // (6, 6h+2, n) routed S/N ghosts (+ sym rows, unread)
  const float* gwe;  // (6, n, 6h+2) routed W/E ghosts (+ sym columns)
  const float* xc;   // (m,) tan of the cell-center coordinates
  const float* xf;   // (m,) tan of the left-face coordinates
  float* ho;         // (6, n, n)
  float* uo;         // (2, 6, n, n)
  float* ssn;        // (6, 6h, n)
  float* swe;        // (6, n, 6h)
  int n, halo;
  float R2, invd, inv2d, damp;
};

__global__ void __launch_bounds__(BX * BY, 4)
cov_nu4_filter_kernel(const Params p) {
  __shared__ Nu4Window<0> s_w;    // psi on tile + 2, l1 on tile + 1
  __shared__ Nu4Metric<0> s_mt;

  const int n = p.n, hh = p.halo, rw = 6 * hh + 2;
  const int f = blockIdx.z;
  const int i0 = blockIdx.x * TX, j0 = blockIdx.y * TY;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long nn = (long)n * n;
  const float* q[3] = {p.hc + f * nn, p.uc + f * nn, p.uc + (6 + f) * nn};
  const float* gsn = p.gsn + (long)f * rw * n;
  const float* gwe = p.gwe + (long)f * n * rw;

  // ---- 1-2. psi, the metric terms, l1 = lap(psi) on the ring-1 window --
  nu4_window<0>(s_w, s_mt, q, gsn, gwe, p.xc, p.xf, n, hh, j0, i0, p.R2,
                p.invd, p.inv2d);

  // ---- 3. l2 = lap(l1) on the tile, damp, state and strip stores -------
  float* ssn = p.ssn + (long)f * 6 * hh * n;
  float* swe = p.swe + (long)f * n * 6 * hh;
  for (int ly = ty; ly < TY; ly += BY)
    for (int lx = tx; lx < TX; lx += BX) {
      const int j = j0 + ly, i = i0 + lx;
      if (j >= n || i >= n) continue;
      const CellMetric cm = s_mt.at(ly + 1, lx + 1);
      const long cidx = f * nn + (long)j * n + i;
      float* outs[3] = {p.ho + cidx, p.uo + cidx, p.uo + 6 * nn + cidx};
      for (int fi = 0; fi < 3; ++fi) {
        const float v = nu4_filtered<0>(s_w, fi, ly, lx, cm, p.invd,
                                        p.inv2d, p.damp);
        *outs[fi] = v;
        put_strips(ssn, swe, fi, n, hh, j, i, v);
      }
    }
}

}  // namespace

// Launches the filter on `stream`; returns cudaGetLastError() (0 = ok).
// All tensors float32, contiguous, in the layouts of Params.
extern "C" int cov_nu4_filter_f32(
    const float* hc, const float* uc, const float* gsn, const float* gwe,
    const float* xc, const float* xf, float* ho, float* uo, float* ssn,
    float* swe, int n, int halo, float R2, float invd, float inv2d,
    float damp, void* stream) {
  Params p{hc, uc, gsn, gwe, xc, xf, ho, uo, ssn, swe,
           n, halo, R2, invd, inv2d, damp};
  const dim3 grid((n + TX - 1) / TX, (n + TY - 1) / TY, 6);
  const dim3 block(BX, BY);
  cov_nu4_filter_kernel<<<grid, block, 0,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
