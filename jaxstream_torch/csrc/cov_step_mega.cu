// One whole SSPRK3 step of the covariant shallow-water equations over the
// compact carry, routes included, in one cooperative launch: the Hopper
// (sm_90a) kernel of jaxstream_torch's whole-step stepper.
//
// Replaces the Pallas TPU kernel make_fused_ssprk3_cov_mega
// (jaxstream/experiments/swe_mega.py:131, pallas_call at :344).  The
// plain PyTorch version of the same function is
// jaxstream_torch.experiments.swe_mega.cov_mega_step_reference; the
// kernel reproduces its operations in its order (built with
// -fmad=false, so every multiply and add rounds separately, as
// PyTorch's do).
//
// What it computes: three times
//   route    from the stage's boundary strips sn (6, 6h, n) / we (6, n,
//            6h), the routed ghosts gsn (6, 6h+2, n) / gwe (6, n, 6h+2)
//            of the split router (jaxstream_torch.ops.cuda.swe_cov.
//            _SplitRoute): a static row gather (idx, into [sn ; we^T ;
//            their lane flips]), the 2 x 2 covariant rotations (T_sn,
//            T_we) and the pair average of the edge normals, not
//            prescaled;
//   faces    the compact stage (cov_stage.cu) on every tile: ghosts from
//            gsn / gwe, rhs_core_cov with the un-prescaled sym rows (the
//            tile multiplies them by the edge sqrtg), the combine
//            (A y0 + B cur) + C tend with the stage's row of the float32
//            table AB, and the new boundary strips.
//
// Design.  The TPU kernel runs a grid of 3 x (1 router + 6 faces) steps
// in order with the whole state in VMEM.  An H100 runs blocks
// concurrently, and 10.6 MB of state does not fit in shared memory, so
// here the state stays in global memory (L2 holds it: 50 MB) and the
// phases are separated by grid-wide barriers: one cooperative launch of
// as many 256-thread blocks as can be resident at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM count), each
// looping over work.  A router phase gives each thread routed elements
// (one ghost or sym value each, computed straight from the strips: no
// barrier inside the router); a face phase gives each block 32 x 16
// tiles.  A tile's apron reads its neighbours' cells, so the faces may
// not overwrite their input: stage 1 writes y0 -> out, stage 2 out -> B,
// stage 3 B -> out.  The strips need one buffer (the router reads them
// before the next face phase writes them).  Data written inside the
// launch is read with __ldcg (L2, coherent), never through the
// read-only cache.
//
// Bound.  The compact stepper's three stages move 7.56 + 2 x 10.73 us of
// bytes at C384.  This launch must read the carry and b once and write
// the carry once: 25.5 MB -> ~7.6 us at 3.35 TB/s; what it moves between
// phases stays in L2.

#include <cooperative_groups.h>

#include "cov_common.cuh"

namespace {

using namespace cov;

constexpr int AP = 2;      // h apron: PLR reads two cells past a face

struct Params {
  const float* y0h;  // (6, n, n) the carry: stage base and stage-1 input
  const float* y0u;  // (2, 6, n, n)
  const float* sn0;  // (6, 6h, n) the carry's strips
  const float* we0;  // (6, n, 6h)
  const float* b;    // (6, m, m) orography, ghosts filled
  const float* xc;   // (m,) tan of the cell-center coordinates
  const float* xf;   // (m,) tan of the left-face coordinates
  const float* fz;   // (6, 3) face-frame z components (c0, cx, cy)
  const int* idx;    // routed rows' flat source rows, _SplitRoute.idx
  const float* tsn;  // (4, 6, 2, h, n) placed rotations, S/N slots
  const float* twe;  // (4, 6, 2, h, n) placed rotations, W/E slots
  const float* met;  // (2, 4, n) stored edge-metric rows M0, M1 per slot
  float* ho;         // (6, n, n) out (and stage-1 result)
  float* uo;         // (2, 6, n, n)
  float* sno;        // (6, 6h, n) out strips (every stage's)
  float* weo;        // (6, n, 6h)
  float* bh;         // (6, n, n) the stage-2 result
  float* bu;         // (2, 6, n, n)
  float* gsn;        // (6, 6h+2, n) routed ghosts + sym rows
  float* gwe;        // (6, n, 6h+2)
  int link_row[12];  // per physical edge: the link's face*4 + slot,
  int back_row[12];  // the back's, and whether the pair is reversed
  int rev[12];
  int sym_src[24];   // per face*4 + slot: edge i as link (i) or back (12+i)
  float AB[3][3];    // per stage: A, B, C of (A y0 + B cur) + C tend
  int n, halo, n_sn, n_we;
  float R2, gravity, two_omega, inv2d, inv_d;
};

// The shared memory of a face tile (dynamic: sized at launch).
struct Smem {
  float h[TY + 2 * AP][TX + 2 * AP];
  float ua[TY + 2][TX + 2];
  float ub[TY + 2][TX + 2];
  AdvScratch adv;
};

// The outward sign of slot s (S, N, W, E): -1 at S and W, +1 at N and E.
__device__ __forceinline__ float out_sign(int s) {
  return (s & 1) ? 1.0f : -1.0f;
}

// Row r of [sn ; we^T ; their lane flips] at column k, from the stage's
// strips (written inside the launch from stage 2 on).
__device__ __forceinline__ float strip_row(const Params& p, const float* sn,
                                           const float* we, int r, int k) {
  const int n = p.n, sw = 6 * p.halo, half = 6 * sw;
  if (r >= 2 * half) {        // the lane-flipped copy
    r -= 2 * half;
    k = n - 1 - k;
  }
  if (r < half) return __ldcg(sn + (long)r * n + k);
  r -= half;
  return __ldcg(we + ((long)(r / sw) * n + k) * sw + r % sw);
}

// Routed row `row` (face f, pair p, depth kd) of field fi at column k:
// the gathered row, u rotated by the placed T entries.
__device__ __forceinline__ float routed(const Params& p, const float* sn,
                                        const float* we, const int* idx,
                                        const float* T, int fi, int f, int pr,
                                        int kd, int k) {
  const int n = p.n, hh = p.halo;
  const int per = 6 * 2 * hh;               // rows per field
  const int rf = (f * 2 + pr) * hh + kd;    // row within a field
  if (fi == 0) return strip_row(p, sn, we, idx[rf], k);
  const float c1 = strip_row(p, sn, we, idx[per + rf], k);
  const float c2 = strip_row(p, sn, we, idx[2 * per + rf], k);
  const long t = (long)rf * n + k;
  const long ts = (long)6 * 2 * hh * n;     // one T entry's table
  const int ra = fi == 1 ? 0 : 2;
  return T[ra * ts + t] * c1 + T[(ra + 1) * ts + t] * c2;
}

// The local edge normal of table row `row` (face*4 + slot) at column k:
// M0 ub0 + M1 ub1, ub the mean of the interior edge-adjacent row and the
// rotated edge-adjacent ghost row (_pair_symmetrize's L).
__device__ __forceinline__ float local_normal(const Params& p,
                                              const float* sn,
                                              const float* we, int row,
                                              int k) {
  const int n = p.n, hh = p.halo;
  const int f = row / 4, s = row % 4;
  const int* iu = p.idx + p.n_sn + p.n_we;
  const float iu0 = strip_row(p, sn, we, iu[f * 4 + s], k);
  const float iu1 = strip_row(p, sn, we, iu[(6 + f) * 4 + s], k);
  const int pr = s & 1;
  const int kd = pr == 0 ? hh - 1 : 0;      // placed edge-adjacent depth
  const int* idx = s < 2 ? p.idx : p.idx + p.n_sn;
  const float* T = s < 2 ? p.tsn : p.twe;
  const float ga = routed(p, sn, we, idx, T, 1, f, pr, kd, k);
  const float gb = routed(p, sn, we, idx, T, 2, f, pr, kd, k);
  const float ub0 = 0.5f * (iu0 + ga);
  const float ub1 = 0.5f * (iu1 + gb);
  return p.met[s * n + k] * ub0 + p.met[(4 + s) * n + k] * ub1;
}

// The router phase: every routed ghost and sym element of the stage.
__device__ __forceinline__ void route_phase(const Params& p, const float* sn,
                                            const float* we) {
  const int n = p.n, hh = p.halo, rw = 6 * hh + 2;
  const long n_sn = (long)p.n_sn * n, n_we = (long)p.n_we * n;
  const long total = n_sn + n_we + 24L * n;
  const long stride = (long)gridDim.x * blockDim.x * blockDim.y;
  for (long e = (long)blockIdx.x * blockDim.x * blockDim.y
                + threadIdx.y * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    if (e < n_sn + n_we) {
      const bool is_sn = e < n_sn;
      const long r = is_sn ? e : e - n_sn;
      const int k = r % n, row = r / n;     // row: (fi, f, pair, depth)
      const int kd = row % hh, pr = (row / hh) % 2, f = (row / (2 * hh)) % 6;
      const int fi = row / (12 * hh);
      const float v = routed(p, sn, we, is_sn ? p.idx : p.idx + p.n_sn,
                             is_sn ? p.tsn : p.twe, fi, f, pr, kd, k);
      const int c = fi * 2 * hh + pr * hh + kd;
      if (is_sn) p.gsn[((long)f * rw + c) * n + k] = v;
      else p.gwe[((long)f * n + k) * rw + c] = v;
      continue;
    }
    const long r = e - n_sn - n_we;
    const int k = r % n, row = r / n;       // row: face*4 + slot
    const int src = p.sym_src[row];
    const bool is_link = src < 12;
    const int i = src % 12;
    const int lr = p.link_row[i], br = p.back_row[i];
    const bool rv = p.rev[i] != 0;
    const float sga = out_sign(lr % 4), sgb = out_sign(br % 4);
    const int kk = (is_link || !rv) ? k : n - 1 - k;
    const float la = local_normal(p, sn, we, lr, kk);
    const float lb = local_normal(p, sn, we, br, rv ? n - 1 - kk : kk);
    const float avg = 0.5f * (sga * la - sgb * lb);
    const float v = is_link ? sga * avg : sgb * (-avg);
    const int f = row / 4, s = row % 4;
    if (s < 2) p.gsn[((long)f * rw + 6 * hh + s) * n + k] = v;
    else p.gwe[((long)f * n + k) * rw + 6 * hh + s - 2] = v;
  }
}

// Field fi at face-local (j, i) of face f: the interior q (6, n, n) or an
// edge ghost from the routed blocks; 0 at a ghost corner or past the ring
// (cov_common.cuh's edge_fetch, read through L2).
__device__ __forceinline__ float routed_fetch(const Params& p, const float* q,
                                              int fi, int f, int j, int i) {
  const int n = p.n, hh = p.halo, rw = 6 * hh + 2;
  const bool jin = j >= 0 && j < n;
  const bool iin = i >= 0 && i < n;
  if (jin && iin) return __ldcg(q + ((long)f * n + j) * n + i);
  const float* gsn = p.gsn + (long)f * rw * n;
  const float* gwe = p.gwe + (long)f * n * rw;
  if (iin) {
    if (j < 0 && j >= -hh)
      return __ldcg(gsn + (long)(fi * 2 * hh + (j + hh)) * n + i);
    if (j >= n && j < n + hh)
      return __ldcg(gsn + (long)(fi * 2 * hh + hh + (j - n)) * n + i);
  } else if (jin) {
    if (i < 0 && i >= -hh)
      return __ldcg(gwe + (long)j * rw + fi * 2 * hh + (i + hh));
    if (i >= n && i < n + hh)
      return __ldcg(gwe + (long)j * rw + fi * 2 * hh + hh + (i - n));
  }
  return 0.0f;
}

// The face phase of stage st: every tile of every face.
__device__ __forceinline__ void face_phase(const Params& p, Smem& sm, int st,
                                           const float* ch, const float* cu,
                                           float* oh, float* ou) {
  const int n = p.n, hh = p.halo, m = n + 2 * hh, rw = 6 * hh + 2;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int nx = (n + TX - 1) / TX, ny = (n + TY - 1) / TY;
  const long nn = (long)n * n;
  const float A = p.AB[st][0], B = p.AB[st][1], C = p.AB[st][2];
  const StageConsts k{p.R2, p.gravity, p.two_omega, p.inv2d, p.inv_d};
  for (int t = blockIdx.x; t < 6 * nx * ny; t += gridDim.x) {
    const int f = t / (nx * ny);
    const int j0 = (t / nx) % ny * TY, i0 = t % nx * TX;
    const float* q[3] = {ch, cu, cu + 6 * nn};
    for (int ly = ty; ly < TY + 2 * AP; ly += BY)
      for (int lx = tx; lx < TX + 2 * AP; lx += BX)
        sm.h[ly][lx] = routed_fetch(p, q[0], 0, f, j0 + ly - AP,
                                    i0 + lx - AP);
    for (int ly = ty; ly < TY + 2; ly += BY)
      for (int lx = tx; lx < TX + 2; lx += BX) {
        const int j = j0 + ly - 1, i = i0 + lx - 1;
        sm.ua[ly][lx] = routed_fetch(p, q[1], 1, f, j, i);
        sm.ub[ly][lx] = routed_fetch(p, q[2], 2, f, j, i);
      }
    __syncthreads();

    float* ssn = p.sno + (long)f * 6 * hh * n;
    float* swe = p.weo + (long)f * n * 6 * hh;
    const float* gsn = p.gsn + (long)f * rw * n;
    const float* gwe = p.gwe + (long)f * n * rw;
    advective_tile<false, TX + 2 * AP, TX + 2>(
        &sm.h[0][0], &sm.ua[0][0], &sm.ub[0][0], sm.adv,
        routed_sym(gsn, gwe, n, hh), p.b + (long)f * m * m, p.xc, p.xf,
        p.fz + 3 * f, k, n, hh, j0, i0,
        [&](int ly, int lx, int j, int i, float dh, float dua, float dub) {
          const long c = f * nn + (long)j * n + i;
          const float vals[3] = {
              (A * p.y0h[c] + B * sm.h[ly + AP][lx + AP]) + C * dh,
              (A * p.y0u[c] + B * sm.ua[ly + 1][lx + 1]) + C * dua,
              (A * p.y0u[6 * nn + c] + B * sm.ub[ly + 1][lx + 1]) + C * dub};
          oh[c] = vals[0];
          ou[c] = vals[1];
          ou[6 * nn + c] = vals[2];
          for (int fi = 0; fi < 3; ++fi)
            put_strips(ssn, swe, fi, n, hh, j, i, vals[fi]);
        });
    __syncthreads();         // the next tile restages the shared memory
  }
}

// At least 4 resident blocks per SM caps the kernel at 64 registers, as
// for the stage kernels.
__global__ void __launch_bounds__(BX * BY, 4)
cov_step_mega_kernel(const Params p) {
  extern __shared__ float smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  // Stage inputs and outputs: y0 -> out, out -> B, B -> out.
  const float* ch[3] = {p.y0h, p.ho, p.bh};
  const float* cu[3] = {p.y0u, p.uo, p.bu};
  float* oh[3] = {p.ho, p.bh, p.ho};
  float* ou[3] = {p.uo, p.bu, p.uo};
  for (int st = 0; st < 3; ++st) {
    route_phase(p, st == 0 ? p.sn0 : p.sno, st == 0 ? p.we0 : p.weo);
    grid.sync();
    face_phase(p, sm, st, ch[st], cu[st], oh[st], ou[st]);
    if (st < 2) grid.sync();
  }
}

}  // namespace

// Launches one step on `stream`; returns the launch's cudaError_t (0 =
// ok) and the grid's block count in *blocks.  All tensors float32 (idx
// int32), contiguous, in the layouts of Params; tab holds the host int32
// arrays link_row (12), back_row (12), rev (12), sym_src (24), and ab the
// host float32 table AB (3, 3), both copied into the launch's parameters.
extern "C" int cov_step_mega_f32(
    const float* y0h, const float* y0u, const float* sn0, const float* we0,
    const float* b_ext, const float* xc, const float* xf, const float* fz,
    const int* idx, const float* tsn, const float* twe, const float* met,
    float* ho, float* uo, float* sno, float* weo, float* bh, float* bu,
    float* gsn, float* gwe, const int* tab, const float* ab, int n,
    int halo, int n_sn, int n_we, float R2, float gravity, float two_omega,
    float inv2d, float inv_d, int* blocks, void* stream) {
  Params p{y0h, y0u, sn0, we0, b_ext, xc, xf, fz, idx, tsn, twe, met, ho,
           uo, sno, weo, bh, bu, gsn, gwe, {}, {}, {}, {}, {}, n, halo,
           n_sn, n_we, R2, gravity, two_omega, inv2d, inv_d};
  for (int i = 0; i < 12; ++i) {
    p.link_row[i] = tab[i];
    p.back_row[i] = tab[12 + i];
    p.rev[i] = tab[24 + i];
  }
  for (int i = 0; i < 24; ++i) p.sym_src[i] = tab[36 + i];
  for (int i = 0; i < 9; ++i) p.AB[i / 3][i % 3] = ab[i];

  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cov_step_mega_kernel, BX * BY, sizeof(Smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = per_sm * sms;
  *blocks = nb;
  if (nb < 1) return -1;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(cov_step_mega_kernel, dim3(nb),
                                    dim3(BX, BY), args, sizeof(Smem),
                                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
