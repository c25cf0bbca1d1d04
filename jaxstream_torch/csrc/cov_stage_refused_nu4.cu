// Stage 1 of the covariant shallow-water SSPRK3 step with the del^4
// filter fused in front of it (nu4_mode 'refused'): the Hopper (sm_90a)
// kernel of jaxstream_torch.
//
// Replaces the Pallas TPU kernel make_cov_stage_refused_nu4
// (jaxstream/ops/pallas/swe_cov.py:2748, pallas_call at :2843).  The plain
// PyTorch version of the same function is
// jaxstream_torch.ops.cuda.swe_cov.cov_stage_refused_nu4_reference; the
// kernel reproduces its operations in its order (built with -fmad=false).
//
// What it computes, per face f, from the step's carry (h, u) and its
// routed ghosts gsn (6, 6h+2, n) / gwe (6, n, 6h+2):
//   psi    h, u_a, u_b extended by the routed ghosts, the h x h ghost
//          corners averaged (_fill(corners=True));
//   fv     q - damp lap(lap q) on the interior, damp = f32(dt nu4), the
//          first Laplacian on ring 1 (cov_nu4_filter.cu's arithmetic);
//   E      fv on the interior, the UNFILTERED routed ghosts past the face
//          edge (the re-fused design's O(damp) seam inconsistency: the
//          filtered ghosts would need deeper strips);
//   L(E)   the covariant right-hand side on E (rhs_core_cov, the
//          prescaled sym rows imposed on the boundary faces);
//   out    h1 = fv + f32(dt) L (stage 1: a = 0, b = 1), u1 likewise, the
//          filtered base h0f = fv, u0f = fv_u for stages 2 and 3, and the
//          boundary strips of (h1, u1).
//
// Bound.  It reads h, u, b (14.2 MB at C384) and the ghost blocks
// (0.26 MB) and writes h1, u1, h0f, u0f (21.2 MB) and the strips
// (0.22 MB): ~35.9 MB, 10.7 us at 3.35 TB/s.  Its arithmetic, the filter's
// 169 and the stage's 137 flops per cell on the tile (the apron's
// recomputation left out), is ~0.27 GFLOP, 4.0 us at 67 TFLOP/s: bound by
// memory.  The bytes fit the 50 MB L2; what the kernel spends is the
// latency of its staging and the instructions of its apron.
//
// Design: B1's and B2's faces-in-block body (cov_faces.cuh).  A block of
// 256 threads takes one 32 x 24 tile position and a group of three faces:
// a grid of (ceil(n/32), ceil(n/24), 2), 384 blocks at C384.  The stage
// reads E up to 2 cells past the tile (PLR; u 1 cell), so E is needed on
// tile + 2, l2 there needs l1 on tile + 3, and l1 needs psi on tile + 4.
// The block computes its tile's metric terms once: the Laplacian's over
// the l1 window (LapMetric<30, 38>: the x/y-face pairs and inv_sqrtg / d,
// which also are the stage's face pairs and inv_sqrtg / d on the tile,
// the same floats stage_metric computes), and the stage's band inverse
// metric, sqrtg and inv_rho (BandMetric).  Then per face of its group:
// it stages psi (three fields on tile + 4, each cell by cp.async from the
// interior or the routed strips) with the orography on the Bernoulli
// band, builds the ghost corners in shared memory (one thread per corner
// cell, at most 2 deep: the ring-1 Laplacian reads no deeper), computes
// l1 on the ring-1 window clipped to tile + 3 in one pass, then E in
// place over psi (an E cell reads psi at its own cell only, and l1; off
// the face E is psi as staged), and runs stage_face_tile<Prescaled> on E,
// whose epilogue writes h1, u1, h0f, u0f, and the strips on strip tiles
// only.  The stage reads u on tile + 1 alone, so u is filtered there and
// its l1 computed on tile + 2 (EU).  Shared memory: psi / E 15 360 B, l1
// (the stage's scratch once E is built) 13 680, b 3 536, the Laplacian's
// metric 23 344, the band's 16 752: 72 672 B of dynamic shared memory,
// __launch_bounds__(256, 3): <= 80 registers, 3 blocks per SM, one wave
// (396 slots).  psi is single-buffered: E is built over it, so the next
// face's copies wait for this face's stage.  On an H100 80GB HBM3 at 700 W
// (scripts/torch_faces_probe.py --parts b3b7b) it takes 56.5-58.7 us per
// launch at C384; psi double-buffered (88 KB, two blocks per SM, 1.45
// waves) took 72.4-72.6, u filtered on tile + 2 (EU = 2) 58.3-60.5.

#include "cov_faces.cuh"

namespace {

using namespace cov;

struct Params {
  const float* hc;   // (6, n, n) the step's carry
  const float* uc;   // (2, 6, n, n)
  const float* gsn;  // (6, 6h+2, n) routed S/N ghosts + sym rows
  const float* gwe;  // (6, n, 6h+2) routed W/E ghosts + sym columns
  const float* b;    // (6, m, m) orography, ghosts filled
  const float* xc;   // (m,) tan of the cell-center coordinates
  const float* xf;   // (m,) tan of the left-face coordinates
  const float* fz;   // (6, 3) face-frame z components (c0, cx, cy)
  float* ho;         // (6, n, n) h1
  float* uo;         // (2, 6, n, n) u1
  float* h0f;        // (6, n, n) filtered h
  float* u0f;        // (2, 6, n, n) filtered u
  float* ssn;        // (6, 6h, n) strips of (h1, u1)
  float* swe;        // (6, n, 6h)
  int n, halo;
  // inv2d = f32(1/(2d)) serves the stage and the Laplacians alike: it is
  // the correctly rounded 1/(2d), as f32(0.5/d) is.
  float R2, gravity, two_omega, inv2d, inv_d, g_dt, damp;
};

constexpr int AP = 4;                          // psi apron
constexpr int PY = FTY + 2 * AP, PX = FTX + 2 * AP;   // psi: 32 x 40
constexpr int LA = AP - 1;                     // l1 apron
constexpr int LY = FTY + 2 * LA, LX = FTX + 2 * LA;   // l1: 30 x 38
constexpr int EA = 2;                          // E apron (PLR)
constexpr int EU = 1;                          // u's E apron

// The stage's band inverse metric and the centres' sqrtg and inv_rho:
// stage_metric's terms that the Laplacian's metric does not hold.
struct BandMetric {
  float gaa[FTY + 2][FTX + 2], gab[FTY + 2][FTX + 2], gbb[FTY + 2][FTX + 2];
  float sqrtg[FTY][FTX], irho[FTY][FTX];
};

// One face's staged inputs: psi (then E, in place) and the orography on
// the Bernoulli band.
struct FaceWindow {
  float psi[3][PY][PX];
  float b[FTY + 2][FTX + 2];
};

struct Smem {
  FaceWindow w;
  union {
    float l1[3][LY][LX];
    StageScratch s;             // once E is built
  } x;
  LapMetric<LY, LX> lm;
  BandMetric bm;
};

// E as stage_face_tile reads its window, in psi's layout: h with a 2-deep
// apron, u_a and u_b with a 1-deep one; b on the band.
struct EWindow {
  const float (*h)[PX];
  const float (*ua)[PX];
  const float (*ub)[PX];
  const float (*b)[FTX + 2];
};

// The tile's metric terms as stage_face_tile reads a StageMetric: the face
// pairs and inv_sqrtg / d from the Laplacian's window (its origin LA
// cells before the tile's), the rest from the BandMetric.
struct TileMetric {
  const float (*gaa)[FTX + 2];
  const float (*gab)[FTX + 2];
  const float (*gbb)[FTX + 2];
  const float (*xa)[LX + 1];
  const float (*xb)[LX + 1];
  const float (*ya)[LX];
  const float (*yb)[LX];
  const float (*isgd)[LX];
  const float (*sqrtg)[FTX];
  const float (*irho)[FTX];
};

template <int S>
__device__ __forceinline__ const float (*rows_at(const float* p))[S] {
  return reinterpret_cast<const float(*)[S]>(p);
}

// Fills bm for the tile at (j0, i0) (xc of a whole face) with
// stage_metric's operations.  No barrier.
__device__ __forceinline__ void band_metric(BandMetric& bm,
                                            const float* __restrict__ xc,
                                            float R2, float inv_d, int n,
                                            int hh, int j0, int i0) {
  for_region<FTY + 2, FTX + 2>([&](int ly, int lx) {
    const int j = j0 + ly - 1, i = i0 + lx - 1;
    float g_aa = 0.0f, g_ab = 0.0f, g_bb = 0.0f;
    if (band_cell(n, j, i))
      inverse_metric(xc[i + hh], xc[j + hh], R2, g_aa, g_ab, g_bb);
    bm.gaa[ly][lx] = g_aa;
    bm.gab[ly][lx] = g_ab;
    bm.gbb[ly][lx] = g_bb;
  });
  for_region<FTY, FTX>([&](int ly, int lx) {
    const int j = j0 + ly, i = i0 + lx;
    float isgd = 0.0f, sqrtg = 0.0f, irho = 0.0f;
    if (j < n && i < n)
      center_terms(xc[i + hh], xc[j + hh], R2, inv_d, isgd, sqrtg, irho);
    bm.sqrtg[ly][lx] = sqrtg;
    bm.irho[ly][lx] = irho;
  });
}

// Issues the copies of face f's psi (h, u_a, u_b on rows j0-AP ..
// j0+FTY+AP-1, columns i0-AP .. i0+FTX+AP-1; ghost corners as zeros) and
// of its orography on the band into w (no commit).
__device__ __forceinline__ void stage_psi(const Params& p, FaceWindow& w,
                                          int f, int j0, int i0) {
  const int n = p.n, hh = p.halo, m = n + 2 * hh, rw = 6 * hh + 2;
  const long nn = (long)n * n;
  const float* gsn = p.gsn + (long)f * rw * n;
  const float* gwe = p.gwe + (long)f * n * rw;
  stage_field<PY, AP, PX, AP>(&w.psi[0][0][0], p.hc + f * nn, gsn, gwe, 0,
                              n, hh, rw, j0 - AP, i0);
  stage_field<PY, AP, PX, AP>(&w.psi[1][0][0], p.uc + f * nn, gsn, gwe, 1,
                              n, hh, rw, j0 - AP, i0);
  stage_field<PY, AP, PX, AP>(&w.psi[2][0][0], p.uc + (6 + f) * nn, gsn,
                              gwe, 2, n, hh, rw, j0 - AP, i0);
  stage_band(w.b, p.b + (long)f * m * m, n, hh, j0, i0);
}

__device__ __forceinline__ void refused_faces(const Params& p, Smem& sm,
                                              int f0, int j0, int i0) {
  const int n = p.n, hh = p.halo, rw = 6 * hh + 2;
  const long nn = (long)n * n;
  const StageConsts k{p.R2, p.gravity, p.two_omega, p.inv2d, p.inv_d};
  // The psi window crosses the face edge (ghost corners to build); the
  // tile holds cells of the boundary strips.
  const bool edge = j0 < AP || i0 < AP || j0 + FTY + AP > n
                    || i0 + FTX + AP > n;
  const bool strips = j0 < hh || i0 < hh || j0 + FTY > n - hh
                      || i0 + FTX > n - hh;

  stage_psi(p, sm.w, f0, j0, i0);
  async_commit();
  lap_metric(sm.lm, p.xc, p.xf, n, hh, j0 - LA, i0 - LA, p.R2, p.inv_d);
  band_metric(sm.bm, p.xc, p.R2, p.inv_d, n, hh, j0, i0);

  for (int q = 0; q < FPB; ++q) {
    const int f = f0 + q;
    if (q > 0) {   // E was built over the last face's psi
      stage_psi(p, sm.w, f, j0, i0);
      async_commit();
    }
    async_wait<0>();
    __syncthreads();   // this face's psi (and, first, the metric) complete
    float(*psi)[PY][PX] = sm.w.psi;
    if (edge) {
      for (int fi = 0; fi < 3; ++fi)
        fill_corners<AP, 2, PX, AP>(psi[fi], n, j0, i0);
      __syncthreads();
    }

    // ---- l1 = lap(psi) on the ring-1 window, tile + 3 (u: tile + EU + 1)
    for_region<LY, LX>([&](int wy, int wx) {
      const int r = j0 - LA + wy, c = i0 - LA + wx;
      const bool ok = r >= -1 && r <= n && c >= -1 && c <= n;
      const bool uin = wy >= LA - EU - 1 && wy < LY - (LA - EU - 1)
                       && wx >= LA - EU - 1 && wx < LX - (LA - EU - 1);
      const CellMetric cm = sm.lm.at(wy, wx);
      for (int fi = 0; fi < 3; ++fi)
        if (fi == 0 || uin)
          sm.x.l1[fi][wy][wx] = ok ? lap_at<PX>(&psi[fi][0][0], wy + 1,
                                                wx + 1, cm, p.inv_d, p.inv2d)
                                   : 0.0f;
    });
    __syncthreads();

    // ---- E: q - damp lap(l1) on the face's cells of tile + 2 (u: + EU)
    for_region<FTY + 2 * EA, FTX + 2 * EA>([&](int ey, int ex) {
      const int j = j0 - EA + ey, i = i0 - EA + ex;
      if (j < 0 || j >= n || i < 0 || i >= n) return;
      const bool uin = ey >= EA - EU && ey < FTY + EA + EU
                       && ex >= EA - EU && ex < FTX + EA + EU;
      const CellMetric cm = sm.lm.at(ey + 1, ex + 1);
      for (int fi = 0; fi < 3; ++fi)
        if (fi == 0 || uin) {
          const float l2 = lap_at<LX>(&sm.x.l1[fi][0][0], ey + 1, ex + 1, cm,
                                      p.inv_d, p.inv2d);
          float& e = psi[fi][ey + AP - EA][ex + AP - EA];
          e = e - p.damp * l2;
        }
    });
    __syncthreads();

    // ---- the stage on E; h1, u1, h0f, u0f and strips --------------------
    const float* gsn = p.gsn + (long)f * rw * n;
    const float* gwe = p.gwe + (long)f * n * rw;
    float* ssn = p.ssn + (long)f * 6 * hh * n;
    float* swe = p.swe + (long)f * n * 6 * hh;
    const EWindow e{rows_at<PX>(&psi[0][AP - 2][AP - WOFF]),
                    rows_at<PX>(&psi[1][AP - 1][AP - WOFF]),
                    rows_at<PX>(&psi[2][AP - 1][AP - WOFF]),
                    rows_at<FTX + 2>(&sm.w.b[0][0])};
    const TileMetric tm{rows_at<FTX + 2>(&sm.bm.gaa[0][0]),
                        rows_at<FTX + 2>(&sm.bm.gab[0][0]),
                        rows_at<FTX + 2>(&sm.bm.gbb[0][0]),
                        rows_at<LX + 1>(&sm.lm.xa[LA][LA]),
                        rows_at<LX + 1>(&sm.lm.xb[LA][LA]),
                        rows_at<LX>(&sm.lm.ya[LA][LA]),
                        rows_at<LX>(&sm.lm.yb[LA][LA]),
                        rows_at<LX>(&sm.lm.isg[LA][LA]),
                        rows_at<FTX>(&sm.bm.sqrtg[0][0]),
                        rows_at<FTX>(&sm.bm.irho[0][0])};
    stage_face_tile<Seam::Prescaled>(
        e, tm, sm.x.s, routed_sym(gsn, gwe, n, hh), p.xc, p.xf, p.xc, p.xf,
        p.fz + 3 * f, k, n, hh, j0, i0,
        [&](int, int j, int i, float dh, float dua, float dub, float fh,
            float fa, float fb) {
          const long c = f * nn + (long)j * n + i;
          const float v[3] = {fh + p.g_dt * dh, fa + p.g_dt * dua,
                              fb + p.g_dt * dub};
          p.ho[c] = v[0];
          p.uo[c] = v[1];
          p.uo[6 * nn + c] = v[2];
          p.h0f[c] = fh;
          p.u0f[c] = fa;
          p.u0f[6 * nn + c] = fb;
          if (strips)
            for (int fi = 0; fi < 3; ++fi)
              put_strips(ssn, swe, fi, n, hh, j, i, v[fi]);
        });
    __syncthreads();   // psi / E and the scratch are free for the next face
  }
}

__global__ void __launch_bounds__(NT, 3)
cov_stage_refused_nu4_kernel(const Params p) {
  extern __shared__ float smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  refused_faces(p, sm, blockIdx.z * FPB, blockIdx.y * FTY, blockIdx.x * FTX);
}

}  // namespace

// Launches the re-fused stage 1 on `stream`; returns the cudaError_t of
// the shared memory attribute or of the launch (0 = ok).  All tensors
// float32, contiguous, in the layouts of Params.
extern "C" int cov_stage_refused_nu4_f32(
    const float* hc, const float* uc, const float* gsn, const float* gwe,
    const float* b_ext, const float* xc, const float* xf, const float* fz,
    float* ho, float* uo, float* h0f, float* u0f, float* ssn, float* swe,
    int n, int halo, float R2, float gravity, float two_omega, float inv2d,
    float inv_d, float g_dt, float damp, void* stream) {
  Params p{hc, uc, gsn, gwe, b_ext, xc, xf, fz, ho, uo, h0f, u0f, ssn, swe,
           n, halo, R2, gravity, two_omega, inv2d, inv_d, g_dt, damp};
  const int rc = dynamic_smem_limit(cov_stage_refused_nu4_kernel,
                                    sizeof(Smem));
  if (rc != 0) return rc;
  const dim3 grid((n + FTX - 1) / FTX, (n + FTY - 1) / FTY, 6 / FPB);
  const dim3 block(BX, BY);
  const size_t smem = sizeof(Smem);
  cov_stage_refused_nu4_kernel<<<grid, block, smem,
                                 static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
