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

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;       // tile width along alpha (i)
constexpr int TY = 16;       // tile height along beta (j)
constexpr int BX = 32;       // threads along i
constexpr int BY = 8;        // threads along j
constexpr int WX = TX + 2;   // l1 window: the tile plus ring 1
constexpr int WY = TY + 2;
constexpr int PX = TX + 4;   // psi window: the tile plus a 2-deep apron
constexpr int PY = TY + 4;

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

// Field fi at face-local (j, i): the interior, or an edge ghost from the
// routed blocks; 0 at a corner or past the ghost ring.
__device__ __forceinline__ float edge_fetch(const float* __restrict__ q,
                                            const float* __restrict__ gsn,
                                            const float* __restrict__ gwe,
                                            int fi, int n, int hh, int rw,
                                            int j, int i) {
  const bool jin = j >= 0 && j < n;
  const bool iin = i >= 0 && i < n;
  if (jin && iin) return q[j * n + i];
  if (iin) {
    if (j < 0 && j >= -hh) return gsn[(fi * 2 * hh + (j + hh)) * n + i];
    if (j >= n && j < n + hh) return gsn[(fi * 2 * hh + hh + (j - n)) * n + i];
  } else if (jin) {
    if (i < 0 && i >= -hh) return gwe[j * rw + fi * 2 * hh + (i + hh)];
    if (i >= n && i < n + hh) return gwe[j * rw + fi * 2 * hh + hh + (i - n)];
  }
  return 0.0f;
}

// psi at (j, i) as _fill(corners=True) builds it: a ghost corner is
// 0.5 (S/N ghost at the nearest interior column + W/E ghost at the
// nearest interior row).  Cells past the extended frame are 0 and feed
// no kept output.
__device__ __forceinline__ float filled(const float* __restrict__ q,
                                        const float* __restrict__ gsn,
                                        const float* __restrict__ gwe,
                                        int fi, int n, int hh, int rw,
                                        int j, int i) {
  const bool jout = j < 0 || j >= n;
  const bool iout = i < 0 || i >= n;
  if (jout && iout) {
    if (j < -hh || j >= n + hh || i < -hh || i >= n + hh) return 0.0f;
    const int ie = i < 0 ? 0 : n - 1;
    const int je = j < 0 ? 0 : n - 1;
    return 0.5f * (edge_fetch(q, gsn, gwe, fi, n, hh, rw, j, ie)
                   + edge_fetch(q, gsn, gwe, fi, n, hh, rw, je, i));
  }
  return edge_fetch(q, gsn, gwe, fi, n, hh, rw, j, i);
}

// Face-normal metric terms of the four faces of one cell and its
// inv_sqrtg / d, read from the shared window tables.
struct CellMetric {
  float xa_l, xb_l, xa_r, xb_r;   // x-faces: fg_aa, fg_ab (left, right)
  float yb_b, ya_b, yb_t, ya_t;   // y-faces: fg_bb, fg_ab (bottom, top)
  float isg;                      // inv_sqrtg * (1/d)
};

// lap_core at one cell of a shared window s (row stride S), centred at
// s[y][x]; the same operations in the same order as the plain version.
template <int S>
__device__ __forceinline__ float lap_at(const float* s, int y, int x,
                                        const CellMetric& c, float invd,
                                        float inv2d) {
  const float* p = s + y * S + x;
  const float dpbc_m = (p[S - 1] - p[-S - 1]) * inv2d;
  const float dpbc_0 = (p[S] - p[-S]) * inv2d;
  const float dpbc_p = (p[S + 1] - p[-S + 1]) * inv2d;
  const float fx_l = c.xa_l * ((p[0] - p[-1]) * invd)
                   + c.xb_l * (0.5f * (dpbc_m + dpbc_0));
  const float fx_r = c.xa_r * ((p[1] - p[0]) * invd)
                   + c.xb_r * (0.5f * (dpbc_0 + dpbc_p));
  const float dpac_m = (p[-S + 1] - p[-S - 1]) * inv2d;
  const float dpac_0 = (p[1] - p[-1]) * inv2d;
  const float dpac_p = (p[S + 1] - p[S - 1]) * inv2d;
  const float fy_b = c.yb_b * ((p[0] - p[-S]) * invd)
                   + c.ya_b * (0.5f * (dpac_m + dpac_0));
  const float fy_t = c.yb_t * ((p[S] - p[0]) * invd)
                   + c.ya_t * (0.5f * (dpac_0 + dpac_p));
  return ((fx_r - fx_l) + (fy_t - fy_b)) * c.isg;
}

__global__ void __launch_bounds__(BX * BY)
cov_nu4_filter_kernel(const Params p) {
  __shared__ float s_psi[3][PY][PX];
  __shared__ float s_l1[3][WY][WX];
  // Metric terms of the l1 window, indexed by window cell: x-face k is
  // the left face of window column k, y-face k the lower face of row k.
  __shared__ float s_xa[WY][WX + 1];   // fg_aa at x-faces
  __shared__ float s_xb[WY][WX + 1];   // fg_ab at x-faces
  __shared__ float s_ya[WY + 1][WX];   // fg_ab at y-faces
  __shared__ float s_yb[WY + 1][WX];   // fg_bb at y-faces
  __shared__ float s_isg[WY][WX];      // inv_sqrtg * (1/d) at centers

  const int n = p.n, hh = p.halo, rw = 6 * hh + 2;
  const int f = blockIdx.z;
  const int i0 = blockIdx.x * TX, j0 = blockIdx.y * TY;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long nn = (long)n * n;
  const float* q[3] = {p.hc + f * nn, p.uc + f * nn, p.uc + (6 + f) * nn};
  const float* gsn = p.gsn + (long)f * rw * n;
  const float* gwe = p.gwe + (long)f * n * rw;
  const float* xc = p.xc;
  const float* xf = p.xf;
  const float invd = p.invd, inv2d = p.inv2d;

  // ---- 1. psi windows and the window's metric terms ------------------
  for (int ly = ty; ly < PY; ly += BY)
    for (int lx = tx; lx < PX; lx += BX) {
      const int j = j0 + ly - 2, i = i0 + lx - 2;
      for (int fi = 0; fi < 3; ++fi)
        s_psi[fi][ly][lx] = filled(q[fi], gsn, gwe, fi, n, hh, rw, j, i);
    }
  // x-faces between columns c-1 | c, on rows r in [-1, n].
  for (int wy = ty; wy < WY; wy += BY)
    for (int k = tx; k < WX + 1; k += BX) {
      const int r = j0 - 1 + wy, c = i0 - 1 + k;
      float fa = 0.0f, fb = 0.0f;
      if (r >= -1 && r <= n && c >= -1 && c <= n + 1) {
        const float x = xf[c + hh], y = xc[r + hh];
        const float y2 = y * y;
        const float dydb = 1.0f + y2;
        const float rho2 = (1.0f + x * x) + y2;
        const float inv_rho = rsqrtf(rho2);
        fa = dydb * inv_rho;
        fb = (x * y) * inv_rho;
      }
      s_xa[wy][k] = fa;
      s_xb[wy][k] = fb;
    }
  // y-faces between rows r-1 | r, on columns c in [-1, n].
  for (int k = ty; k < WY + 1; k += BY)
    for (int wx = tx; wx < WX; wx += BX) {
      const int r = j0 - 1 + k, c = i0 - 1 + wx;
      float fa = 0.0f, fb = 0.0f;
      if (r >= -1 && r <= n + 1 && c >= -1 && c <= n) {
        const float x = xc[c + hh], y = xf[r + hh];
        const float dxda = 1.0f + x * x;
        const float rho2 = dxda + y * y;
        const float inv_rho = rsqrtf(rho2);
        fa = (x * y) * inv_rho;
        fb = dxda * inv_rho;
      }
      s_ya[k][wx] = fa;
      s_yb[k][wx] = fb;
    }
  for (int wy = ty; wy < WY; wy += BY)
    for (int wx = tx; wx < WX; wx += BX) {
      const int r = j0 - 1 + wy, c = i0 - 1 + wx;
      float isg = 0.0f;
      if (r >= -1 && r <= n && c >= -1 && c <= n) {
        const float x = xc[c + hh], y = xc[r + hh];
        const float dxda = 1.0f + x * x;
        const float dydb = 1.0f + y * y;
        const float rho2 = dxda + y * y;
        const float inv_rho = rsqrtf(rho2);
        const float sg_row = p.R2 * dxda;
        const float inv_sqrtg = ((1.0f / sg_row) * (1.0f / dydb))
                              * (rho2 * rho2 * inv_rho);
        isg = inv_sqrtg * invd;
      }
      s_isg[wy][wx] = isg;
    }
  __syncthreads();

  // ---- 2. l1 = lap(psi) on the ring-1 window ---------------------------
  for (int wy = ty; wy < WY; wy += BY)
    for (int wx = tx; wx < WX; wx += BX) {
      const int r = j0 - 1 + wy, c = i0 - 1 + wx;
      const bool ok = r >= -1 && r <= n && c >= -1 && c <= n;
      const CellMetric cm{s_xa[wy][wx], s_xb[wy][wx], s_xa[wy][wx + 1],
                          s_xb[wy][wx + 1], s_yb[wy][wx], s_ya[wy][wx],
                          s_yb[wy + 1][wx], s_ya[wy + 1][wx], s_isg[wy][wx]};
      for (int fi = 0; fi < 3; ++fi)
        s_l1[fi][wy][wx] =
            ok ? lap_at<PX>(&s_psi[fi][0][0], wy + 1, wx + 1, cm, invd, inv2d)
               : 0.0f;
    }
  __syncthreads();

  // ---- 3. l2 = lap(l1) on the tile, damp, state and strip stores -------
  const int sw = 6 * hh;   // strip width
  float* ssn = p.ssn + (long)f * sw * n;
  float* swe = p.swe + (long)f * n * sw;
  for (int ly = ty; ly < TY; ly += BY)
    for (int lx = tx; lx < TX; lx += BX) {
      const int j = j0 + ly, i = i0 + lx;
      if (j >= n || i >= n) continue;
      const int wy = ly + 1, wx = lx + 1;
      const CellMetric cm{s_xa[wy][wx], s_xb[wy][wx], s_xa[wy][wx + 1],
                          s_xb[wy][wx + 1], s_yb[wy][wx], s_ya[wy][wx],
                          s_yb[wy + 1][wx], s_ya[wy + 1][wx], s_isg[wy][wx]};
      const long cidx = f * nn + (long)j * n + i;
      float* outs[3] = {p.ho + cidx, p.uo + cidx, p.uo + 6 * nn + cidx};
      for (int fi = 0; fi < 3; ++fi) {
        const float l2 = lap_at<WX>(&s_l1[fi][0][0], wy, wx, cm, invd, inv2d);
        const float v = s_psi[fi][ly + 2][lx + 2] - p.damp * l2;
        *outs[fi] = v;
        // Boundary strips in pack_strips_cov_split's layout.
        const int base = fi * 2 * hh;
        if (j < hh) ssn[(base + j) * n + i] = v;
        if (j >= n - hh) ssn[(base + hh + j - (n - hh)) * n + i] = v;
        if (i < hh) swe[(long)j * sw + base + i] = v;
        if (i >= n - hh) swe[(long)j * sw + base + hh + i - (n - hh)] = v;
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
