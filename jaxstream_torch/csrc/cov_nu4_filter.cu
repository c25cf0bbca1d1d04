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
// Bound.  The filter reads h, u (10.6 MB at C384) and the ghost blocks
// (0.26 MB) and writes h, u (10.6 MB) and the strips (0.22 MB): ~21.7 MB,
// 6.5 us at 3.35 TB/s.  Its arithmetic is 169 flops per cell (22 per
// Laplacian per field, 2 for the damp per field, 31 for the shared metric
// terms), ~0.15 GFLOP at C384, 2.2 us at 67 TFLOP/s: bound by memory.
// The bytes fit the 50 MB L2; a tile-per-block kernel spends its time on
// the window's latency (scalar, branchy ghost fetches with nothing to
// overlap them) and on the metric terms, rebuilt for each face.
//
// Design.  A block of 256 threads takes one 32 x 24 output tile position
// and a group of three faces (cov_faces.cuh): a grid of (ceil(n/32),
// ceil(n/24), 2), 12 x 16 x 2 = 384 blocks at C384.  It issues the
// asynchronous copies (cp.async) of its first face's psi (three fields on
// the tile plus a 2-deep apron, each cell from the interior or the routed
// strips), computes the l1 window's metric terms once into shared memory
// (LapMetric: the floats lap_at reads, once and not per face), and then per
// face of its group issues the next face's psi into the other buffer,
// waits for this face's, builds the ghost corners from the staged edges
// in shared memory (tiles at a face edge only), computes l1 of the three
// fields on the (FTY+2) x (FTX+2) window, then l2 and the outputs.  Each
// per-cell phase maps one tile column to one lane (for_region).  One code
// path serves every tile, as in cov_stage.cu.  Occupancy: 52 960 B of
// dynamic shared memory (psi 2 x 12 096, l1 10 608, metric 18 160) and
// __launch_bounds__(256, 3): <= 80 registers; 384 blocks on 132 SMs x 3
// slots = 396: one wave, 120 SMs with three blocks and 12 with two.

#include "cov_faces.cuh"

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

constexpr int PY = FTY + 4;             // psi window: tile + 2
constexpr int LY = FTY + 2, LX = FTX + 2;   // l1 window: tile + 1

struct Smem {
  float psi[2][3][PY][WS];   // this face's and the next one's
  float l1[3][LY][LX];
  LapMetric<LY, LX> mt;
};

// Issues the copies of face f's psi (h, u_a, u_b on rows j0-2 .. j0+FTY+1,
// columns i0-2 .. i0+FTX+1) into psi (no commit); edge tiles stage the
// ghost corners as zeros.
__device__ __forceinline__ void stage_psi(const Params& p,
                                          float (*psi)[PY][WS], int f,
                                          int j0, int i0) {
  const int n = p.n, hh = p.halo, rw = 6 * hh + 2;
  const long nn = (long)n * n;
  const float* gsn = p.gsn + (long)f * rw * n;
  const float* gwe = p.gwe + (long)f * n * rw;
  stage_field<PY, 2>(&psi[0][0][0], p.hc + f * nn, gsn, gwe, 0, n, hh, rw,
                     j0 - 2, i0);
  stage_field<PY, 2>(&psi[1][0][0], p.uc + f * nn, gsn, gwe, 1, n, hh, rw,
                     j0 - 2, i0);
  stage_field<PY, 2>(&psi[2][0][0], p.uc + (6 + f) * nn, gsn, gwe, 2, n, hh,
                     rw, j0 - 2, i0);
}

// The h x h ghost corners of the staged psi: _fill(corners=True)'s
// average of the S/N ghost at the nearest interior column and the W/E
// ghost at the nearest interior row, both in the window already.
__device__ __forceinline__ void fill_corners(float (*psi)[PY][WS], int n,
                                             int hh, int j0, int i0) {
  const int t = threadIdx.y * BX + threadIdx.x;
  constexpr int COLS = FTX + 4;
  for (int o = t; o < PY * COLS; o += NT) {
    const int r = o / COLS, c = o - r * COLS - 2;
    const int j = j0 - 2 + r, i = i0 + c;
    if (!((j < 0 || j >= n) && (i < 0 || i >= n))) continue;
    if (j < -hh || j >= n + hh || i < -hh || i >= n + hh) continue;
    const int ce = (i < 0 ? 0 : n - 1) - i0;   // nearest interior column
    const int re = (j < 0 ? 0 : n - 1) - (j0 - 2);   // and row
    for (int fi = 0; fi < 3; ++fi)
      psi[fi][r][WOFF + c] = 0.5f * (psi[fi][r][WOFF + ce]
                                     + psi[fi][re][WOFF + c]);
  }
}

__device__ __forceinline__ void filter_faces(const Params& p, Smem& sm,
                                             int f0, int j0, int i0) {
  const int n = p.n, hh = p.halo;
  const long nn = (long)n * n;
  const int tx = threadIdx.x, ty = threadIdx.y;
  // The window crosses the face edge (ghost corners to build), the tile
  // holds cells of the boundary strips.
  const bool edge = j0 < 2 || i0 < 2 || j0 + FTY + 2 > n || i0 + FTX + 2 > n;
  const bool strips = j0 < hh || i0 < hh || j0 + FTY > n - hh
                      || i0 + FTX > n - hh;

  stage_psi(p, sm.psi[0], f0, j0, i0);
  async_commit();
  lap_metric(sm.mt, p.xc, p.xf, n, hh, j0 - 1, i0 - 1, p.R2, p.invd);

  for (int q = 0; q < FPB; ++q) {
    const int f = f0 + q, cur = q & 1;
    if (q + 1 < FPB) {
      stage_psi(p, sm.psi[cur ^ 1], f + 1, j0, i0);
      async_commit();
      async_wait<1>();
    } else {
      async_wait<0>();
    }
    __syncthreads();   // this face's psi (and, first, mt) complete
    float(*psi)[PY][WS] = sm.psi[cur];
    if (edge) {
      fill_corners(psi, n, hh, j0, i0);
      __syncthreads();
    }

    // ---- l1 = lap(psi) on the ring-1 window ------------------------------
    for_region<LY, LX>([&](int wy, int wx) {
      const int r = j0 - 1 + wy, c = i0 - 1 + wx;
      const bool ok = r >= -1 && r <= n && c >= -1 && c <= n;
      const CellMetric cm = sm.mt.at(wy, wx);
      for (int fi = 0; fi < 3; ++fi)
        sm.l1[fi][wy][wx] = ok ? lap_at<WS>(&psi[fi][0][0], wy + 1,
                                            WOFF - 1 + wx, cm, p.invd,
                                            p.inv2d)
                               : 0.0f;
    });
    __syncthreads();

    // ---- l2 = lap(l1) on the tile, damp, state and strip stores ---------
    float* ssn = p.ssn + (long)f * 6 * hh * n;
    float* swe = p.swe + (long)f * n * 6 * hh;
    for (int ly = ty; ly < FTY; ly += BY) {
      const int lx = tx;
      const int j = j0 + ly, i = i0 + lx;
      if (j >= n || i >= n) continue;
      const CellMetric cm = sm.mt.at(ly + 1, lx + 1);
      const long cidx = f * nn + (long)j * n + i;
      float* outs[3] = {p.ho + cidx, p.uo + cidx, p.uo + 6 * nn + cidx};
      for (int fi = 0; fi < 3; ++fi) {
        const float l2 = lap_at<LX>(&sm.l1[fi][0][0], ly + 1, lx + 1, cm,
                                    p.invd, p.inv2d);
        const float v = psi[fi][ly + 2][WOFF + lx] - p.damp * l2;
        *outs[fi] = v;
        if (strips) put_strips(ssn, swe, fi, n, hh, j, i, v);
      }
    }
    __syncthreads();   // psi[cur] and l1 are free for the next face
  }
}

__global__ void __launch_bounds__(NT, 3)
cov_nu4_filter_kernel(const Params p) {
  extern __shared__ float smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  filter_faces(p, sm, blockIdx.z * FPB, blockIdx.y * FTY, blockIdx.x * FTX);
}

}  // namespace

// Launches the filter on `stream`; returns the cudaError_t of the shared
// memory attribute or of the launch (0 = ok).  All tensors float32,
// contiguous, in the layouts of Params.
extern "C" int cov_nu4_filter_f32(
    const float* hc, const float* uc, const float* gsn, const float* gwe,
    const float* xc, const float* xf, float* ho, float* uo, float* ssn,
    float* swe, int n, int halo, float R2, float invd, float inv2d,
    float damp, void* stream) {
  Params p{hc, uc, gsn, gwe, xc, xf, ho, uo, ssn, swe,
           n, halo, R2, invd, inv2d, damp};
  const int rc = dynamic_smem_limit(cov_nu4_filter_kernel, sizeof(Smem));
  if (rc != 0) return rc;
  const dim3 grid((n + FTX - 1) / FTX, (n + FTY - 1) / FTY, 6 / FPB);
  const dim3 block(BX, BY);
  const size_t smem = sizeof(Smem);
  cov_nu4_filter_kernel<<<grid, block, smem,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
