// One SSPRK3 stage of the covariant shallow-water equations over plain
// extended fields, each face filling its ghosts from its neighbours'
// interiors: the Hopper (sm_90a) kernel of jaxstream_torch's
// neighbour-read stepper (no router, no strip carry).
//
// Replaces the Pallas TPU kernel make_cov_stage_nbr
// (jaxstream/experiments/swe_cov_nbr.py:127, pallas_call at :404).  The
// plain PyTorch version of the same function is
// jaxstream_torch.experiments.swe_cov_nbr.cov_stage_nbr_reference; the
// kernel reproduces its operations in its order (built with
// -fmad=false, so every multiply and add rounds separately, as
// PyTorch's do).
//
// What it computes, per face f:
//   frame    each of h, u_a, u_b is its whole input block (6, m, m) with
//            the edge ghosts read from the neighbour face's interior: the
//            ghost at canonical depth d (0 nearest the edge) and along-
//            edge index k of edge e is the neighbour's cell at depth d
//            from its edge, along index k, or n-1-k where the pair is
//            reversed.  u is rotated into this face's basis by the two
//            T entries of the ghost slot (the placed tables T_sn
//            (4, 6, 2, h, n) and T_we (4, 6, 2, n, h)).  The ghost
//            corners stay the input's.
//   sym      the symmetrized edge normal at each boundary face, from
//            both panels' edge-adjacent rows: each panel's local normal
//            m0 ub0 + m1 ub1 (ub the mean of its interior row and its
//            rotated ghost row, m the closed-form edge-metric rows
//            (2, 4, n)), then the pair average.  Both faces of an edge
//            evaluate the same expression on the same operands, so their
//            edge fluxes agree bit for bit and mass stays conserved.  Not
//            prescaled: advective_tile multiplies by the edge sqrtg.
//   out      as cov_stage_inkernel.cu: the whole (m, m) block is val =
//            a*y0 + b*frame (stage 1: the frame), its interior val +
//            b*dt*tend; every cell is written once.
//
// Design.  cov_stage_inkernel.cu's tile, apron and advective_tile<false>
// layout; only the frame fetch changes.  The neighbour of each (face,
// edge) and each edge's pair are small integer tables in the kernel's
// parameters (constant memory).  A tile on a face edge computes that
// edge's sym values for its own cells into shared memory.
//
// Bound.  Stage 1 reads h, u_a, u_b and b (4 x 6 m^2 floats) and writes
// h, u_a, u_b (3 x 6 m^2): at C384 (m = 388) 25.29 MB -> 7.55 us at
// 3.35 TB/s; stages 2-3 also read h0, u0: 36.13 MB -> 10.78 us.  The
// float32 arithmetic (~137 flops per cell) is ~1.8 us: bound by memory.

#include "cov_common.cuh"

namespace {

using namespace cov;

constexpr int AP = 2;      // h apron: PLR reads two cells past a face
// Edge slots, the order of the tables: S, N, W, E.
constexpr int SLOT_S = 0, SLOT_N = 1, SLOT_W = 2, SLOT_E = 3;

struct Params {
  const float* h0;   // (6, m, m) stage base, read only if with_y0
  const float* u0;   // (2, 6, m, m)
  const float* hc;   // (6, m, m) current stage
  const float* uc;   // (2, 6, m, m)
  const float* b;    // (6, m, m) orography, ghosts filled
  const float* tsn;  // (4, 6, 2, h, n) rotations at the S/N ghost slots
  const float* twe;  // (4, 6, 2, n, h) rotations at the W/E ghost slots
  const float* met;  // (2, 4, n) edge-metric rows m0, m1 per slot
  const float* xc;   // (m,) tan of the cell-center coordinates
  const float* xf;   // (m,) tan of the left-face coordinates
  const float* fz;   // (6, 3) face-frame z components (c0, cx, cy)
  float* ho;         // (6, m, m)
  float* uo;         // (2, 6, m, m)
  int conn[6][4][3];  // (face, slot) -> neighbour face, its slot, reversed
  int pair[6][4][5];  // (face, slot) -> link face, link slot, back face,
                      // back slot, is_link
  int n, halo, with_y0;
  float R2, gravity, two_omega, inv2d, inv_d, a, bcoef, g_dt;
};

// The outward sign of a slot's edge: -1 at S and W, +1 at N and E.
__device__ __forceinline__ float out_sign(int s) {
  return (s == SLOT_N || s == SLOT_E) ? 1.0f : -1.0f;
}

// Interior cell (j, i) (face-local) of face g at canonical depth d from
// its edge s and along-edge index k.
__device__ __forceinline__ long src_cell(int g, int s, int d, int k, int n,
                                         int hh) {
  const int m = n + 2 * hh;
  int j, i;
  if (s == SLOT_S) { j = d; i = k; }
  else if (s == SLOT_N) { j = n - 1 - d; i = k; }
  else if (s == SLOT_W) { j = k; i = d; }
  else { j = k; i = n - 1 - d; }
  return (long)g * m * m + (long)(j + hh) * m + i + hh;
}

// T entry r of face f's ghost slot at edge s, canonical depth d, along k.
__device__ __forceinline__ float t_at(const Params& p, int r, int f, int s,
                                      int d, int k) {
  const int n = p.n, hh = p.halo;
  const long blk = ((long)(r * 6 + f) * 2 + (s & 1)) * hh * n;
  if (s == SLOT_S) return p.tsn[blk + (long)(hh - 1 - d) * n + k];
  if (s == SLOT_N) return p.tsn[blk + (long)d * n + k];
  if (s == SLOT_W) return p.twe[blk + (long)k * hh + hh - 1 - d];
  return p.twe[blk + (long)k * hh + d];
}

// Field fi of face f's ghost at edge s, canonical depth d, along k: the
// neighbour's interior cell, u rotated into face f's basis.
__device__ __forceinline__ float ghost(const Params& p, int fi, int f, int s,
                                       int d, int k) {
  const int n = p.n, hh = p.halo;
  const long mm = (long)(n + 2 * hh) * (n + 2 * hh);
  const int* c = p.conn[f][s];
  const long cell = src_cell(c[0], c[1], d, c[2] ? n - 1 - k : k, n, hh);
  if (fi == 0) return p.hc[cell];
  const float r0 = p.uc[cell], r1 = p.uc[6 * mm + cell];
  const int ra = fi == 1 ? 0 : 2;
  return t_at(p, ra, f, s, d, k) * r0 + t_at(p, ra + 1, f, s, d, k) * r1;
}

// The stage's frame of field fi at face-local (j, i) of face f: the input
// block, its edge ghosts from the neighbours.  0 past the frame (the
// ragged last tiles' aprons, which feed no kept output).
__device__ __forceinline__ float frame_nbr(const Params& p, int fi, int f,
                                           int j, int i) {
  const int n = p.n, hh = p.halo, m = n + 2 * hh;
  if (j < -hh || j >= n + hh || i < -hh || i >= n + hh) return 0.0f;
  const bool jin = j >= 0 && j < n;
  const bool iin = i >= 0 && i < n;
  if (iin && !jin)
    return j < 0 ? ghost(p, fi, f, SLOT_S, -1 - j, i)
                 : ghost(p, fi, f, SLOT_N, j - n, i);
  if (jin && !iin)
    return i < 0 ? ghost(p, fi, f, SLOT_W, -1 - i, j)
                 : ghost(p, fi, f, SLOT_E, i - n, j);
  const long mm = (long)m * m;
  const float* q = fi == 0 ? p.hc : p.uc + (fi == 2 ? 6 * mm : 0);
  return q[f * mm + (long)(j + hh) * m + i + hh];
}

// Face f's own normal velocity at edge s, along index k: m0 ub0 + m1 ub1
// with ub the mean of its rotated edge-adjacent ghost and its
// edge-adjacent interior cell.
__device__ __forceinline__ float local_normal(const Params& p, int f, int s,
                                              int k) {
  const int n = p.n, hh = p.halo;
  const long mm = (long)(n + 2 * hh) * (n + 2 * hh);
  const int* c = p.conn[f][s];
  const long src = src_cell(c[0], c[1], 0, c[2] ? n - 1 - k : k, n, hh);
  const float r0 = p.uc[src], r1 = p.uc[6 * mm + src];
  const float gi0 = t_at(p, 0, f, s, 0, k) * r0 + t_at(p, 1, f, s, 0, k) * r1;
  const float gi1 = t_at(p, 2, f, s, 0, k) * r0 + t_at(p, 3, f, s, 0, k) * r1;
  const long own = src_cell(f, s, 0, k, n, hh);
  const float ub0 = 0.5f * (gi0 + p.uc[own]);
  const float ub1 = 0.5f * (gi1 + p.uc[6 * mm + own]);
  return p.met[s * n + k] * ub0 + p.met[(4 + s) * n + k] * ub1;
}

// The symmetrized edge normal of face f at edge s, along index k.
__device__ __forceinline__ float sym_normal(const Params& p, int f, int s,
                                            int k) {
  const int n = p.n;
  const int* q = p.pair[f][s];
  const int lf = q[0], ls = q[1], bf = q[2], bs = q[3];
  const bool rev = p.conn[lf][ls][2] != 0;
  const float sga = out_sign(ls), sgb = out_sign(bs);
  // avg at the link's index kk: link normal at kk, back normal at the
  // matching (reversed) index.
  const int kk = (q[4] || !rev) ? k : n - 1 - k;
  const float nl = local_normal(p, lf, ls, kk);
  const float nb = local_normal(p, bf, bs, rev ? n - 1 - kk : kk);
  const float avg = 0.5f * (sga * nl - sgb * nb);
  return q[4] ? sga * avg : sgb * (-avg);
}

// At least 4 resident blocks per SM caps the kernel at 64 registers, as
// for the other stage kernels.
__global__ void __launch_bounds__(BX * BY, 4)
cov_stage_nbr_kernel(const Params p) {
  __shared__ float s_h[TY + 2 * AP][TX + 2 * AP];
  __shared__ float s_ua[TY + 2][TX + 2];
  __shared__ float s_ub[TY + 2][TX + 2];
  __shared__ float s_sym[4][TX > TY ? TX : TY];
  __shared__ AdvScratch s_adv;

  const int n = p.n, hh = p.halo, m = n + 2 * hh;
  const int f = blockIdx.z;
  const int i0 = blockIdx.x * TX, j0 = blockIdx.y * TY;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long mm = (long)m * m;

  // ---- 1. stage the tile with its aprons; this tile's sym values --------
  for (int ly = ty; ly < TY + 2 * AP; ly += BY)
    for (int lx = tx; lx < TX + 2 * AP; lx += BX)
      s_h[ly][lx] = frame_nbr(p, 0, f, j0 + ly - AP, i0 + lx - AP);
  for (int ly = ty; ly < TY + 2; ly += BY)
    for (int lx = tx; lx < TX + 2; lx += BX) {
      const int j = j0 + ly - 1, i = i0 + lx - 1;
      s_ua[ly][lx] = frame_nbr(p, 1, f, j, i);
      s_ub[ly][lx] = frame_nbr(p, 2, f, j, i);
    }
  {
    const int t = ty * BX + tx;
    const bool on[4] = {j0 == 0, j0 + TY >= n, i0 == 0, i0 + TX >= n};
    if (t < 4 * TX) {
      const int s = t / TX, l = t % TX;
      const int k = (s < 2 ? i0 : j0) + l;
      if (on[s] && l < (s < 2 ? TX : TY) && k < n)
        s_sym[s][l] = sym_normal(p, f, s, k);
    }
  }

  // ---- 2. the ghost ring cells of this tile: a*y0 + b*frame -------------
  // Ring cell (j, i) belongs to the tile holding its nearest interior
  // cell; interior tiles own none.
  const int jlo = j0 == 0 ? -hh : j0;
  const int jhi = j0 + TY >= n ? n + hh : j0 + TY;
  const int ilo = i0 == 0 ? -hh : i0;
  const int ihi = i0 + TX >= n ? n + hh : i0 + TX;
  if (jlo < 0 || jhi > n || ilo < 0 || ihi > n)
    for (int j = jlo + ty; j < jhi; j += BY)
      for (int i = ilo + tx; i < ihi; i += BX) {
        if (j >= 0 && j < n && i >= 0 && i < n) continue;
        const long c = f * mm + (long)(j + hh) * m + i + hh;
        for (int fi = 0; fi < 3; ++fi) {
          const float fr = frame_nbr(p, fi, f, j, i);
          const long cf = c + (fi == 2 ? 6 * mm : 0);
          float v = fr;
          if (p.with_y0)
            v = p.a * (fi == 0 ? p.h0 : p.u0)[cf] + p.bcoef * fr;
          (fi == 0 ? p.ho : p.uo)[cf] = v;
        }
      }
  __syncthreads();

  // ---- 3. tendencies, RK combine, interior stores -----------------------
  // The sym rows indexed by the face's along-edge index, as
  // advective_tile reads them; only this tile's entries are read.
  const SymRows rows{&s_sym[0][0] - i0, &s_sym[1][0] - i0,
                     &s_sym[2][0] - j0, &s_sym[3][0] - j0, 1};
  const StageConsts k{p.R2, p.gravity, p.two_omega, p.inv2d, p.inv_d};
  advective_tile<false, TX + 2 * AP, TX + 2>(
      &s_h[0][0], &s_ua[0][0], &s_ub[0][0], s_adv, rows, p.b + f * mm,
      p.xc, p.xf, p.fz + 3 * f, k, n, hh, j0, i0,
      [=](int ly, int lx, int j, int i, float dh, float dua, float dub) {
        const long c = f * mm + (long)(j + hh) * m + i + hh;
        float y0h = 0.0f, y0a = 0.0f, y0b = 0.0f;
        if (p.with_y0) {
          y0h = p.h0[c];
          y0a = p.u0[c];
          y0b = p.u0[6 * mm + c];
        }
        p.ho[c] = combine(p.with_y0, p.a, p.bcoef, p.g_dt, y0h,
                          s_h[ly + AP][lx + AP], dh);
        p.uo[c] = combine(p.with_y0, p.a, p.bcoef, p.g_dt, y0a,
                          s_ua[ly + 1][lx + 1], dua);
        p.uo[6 * mm + c] = combine(p.with_y0, p.a, p.bcoef, p.g_dt, y0b,
                                   s_ub[ly + 1][lx + 1], dub);
      });
}

}  // namespace

// Launches one stage on `stream`; returns cudaGetLastError() (0 = ok).
// with_y0 == 0: frame + g_dt*L (stage 1); with_y0 != 0: (a*y0 + b*frame)
// + g_dt*L (stages 2-3; h0/u0 read only then).  All tensors float32,
// contiguous, in the layouts of Params; conn (6, 4, 3) and pair (6, 4, 5)
// are host int32 arrays, copied into the launch's parameters.
extern "C" int cov_stage_nbr_f32(
    const float* h0, const float* u0, const float* hc, const float* uc,
    const float* b_ext, const float* tsn, const float* twe,
    const float* met, const float* xc, const float* xf, const float* fz,
    float* ho, float* uo, const int* conn, const int* pair, int n, int halo,
    int with_y0, float R2, float gravity, float two_omega, float inv2d,
    float inv_d, float a, float b, float g_dt, void* stream) {
  Params p{h0, u0, hc, uc, b_ext, tsn, twe, met, xc, xf, fz, ho, uo, {}, {},
           n, halo, with_y0, R2, gravity, two_omega, inv2d, inv_d, a, b,
           g_dt};
  for (int f = 0; f < 6; ++f)
    for (int s = 0; s < 4; ++s) {
      for (int c = 0; c < 3; ++c) p.conn[f][s][c] = conn[(f * 4 + s) * 3 + c];
      for (int c = 0; c < 5; ++c) p.pair[f][s][c] = pair[(f * 4 + s) * 5 + c];
    }
  const dim3 grid((n + TX - 1) / TX, (n + TY - 1) / TY, 6);
  const dim3 block(BX, BY);
  cov_stage_nbr_kernel<<<grid, block, 0,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
