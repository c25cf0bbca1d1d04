// One SSPRK3 stage of the covariant shallow-water equations over
// interior-only state, with the knobs of the JAX package's compact stage
// that cov_stage.cu leaves out: the ensemble member axis, the 16-bit carry
// encodings and the stage precision policy.  The Hopper (sm_90a) kernel of
// jaxstream_torch.
//
// Replaces, as cov_stage.cu does, the Pallas TPU kernel
// make_cov_stage_compact (jaxstream/ops/pallas/swe_cov.py:1689,
// pallas_call at :1989), here with its groups = 6 B, carry_dtype /
// h_offset / h_scale / u_scale and precision arguments.  The plain
// PyTorch version is jaxstream_torch.ops.cuda.swe_cov.
// cov_stage_compact_reference; the kernel reproduces its operations in
// its order (-fmad=false; every bfloat16 operation a float32 one rounded,
// cov_half.cuh).  cov_stage.cu keeps the plain case (one member, float32
// carry and strips, float32 arithmetic) in code of its own.
//
// What it adds to cov_stage.cu's stage, per launch parameter:
//   members  the carry holds B members: faces 6 B deep, member-major
//            (face f of the fold is member f / 6, face f % 6).  The grid's
//            z extent is 2 B; the face-frame z components fz and the
//            orography b, static per face, are read at f % 6, the carry,
//            the routed ghosts and the outputs at f.  The tile's metric is
//            face-independent, so it is computed once per block as before.
//   hcode, ucode, h_scale, h_off, u_scale
//            the storage of h and u (cov_half.cuh's Carry: float32,
//            bfloat16, float16 or int16), h stored as (h - h_off) /
//            h_scale and u as u / u_scale.  The window decodes (widen,
//            times the scale where it is not 1, plus the offset where it
//            is not 0); the RK combine runs in stored space on the widened
//            stored values, with the tendency constant g_dt / scale
//            (rounded once from float64 by the wrapper); the result is
//            stored rounded to nearest even (int16 saturated), and the
//            strips get it in absolute units (times the scale, plus the
//            offset).
//   s16      the routed ghosts gsn / gwe and the emitted strips are
//            bfloat16: ghost cells are loaded and widened into the
//            window, the sym rows widened into shared memory (SymBuf),
//            the strips narrowed on the store.
//   frame    the sym rows arrive un-prescaled (the JAX package's split
//            del^4 stepper, make_fused_ssprk3_cov_split_nu4, routes
//            them so and its stages take sym_prescaled=False): they get
//            the edge sqrtg as they are staged into SymBuf.
// The bf16 compute policy is the face-state policy R (PlrLo: the limiter
// algebra and the flux face-average velocities in bfloat16), one kernel
// per PLR limiter; cov_stage_policy_bf16.cu builds those, this file the
// float32-arithmetic ones for every reconstruction, and
// cov_stage_members.cu the float32 ensemble's (COV_POLICY_MEMBERS).
//
// Bound.  As cov_stage.cu's (memory): per member 7 (stage 1) or 10 field
// passes of 6 n^2 carry elements, 4 bytes or 2 for a 16-bit carry, plus
// the strips (2 bytes each under s16); the arithmetic does not change
// class.
//
// Design.  cov_stage.cu's faces-in-block body: a block takes one 32 x 24
// tile position and a group of three faces of one member, the metric once
// per tile, the next face's window staged while this one computes.
// Float32 cells (the carry where it is stored raw, float32 ghosts, the
// orography) are copied by cp.async; decoded and 16-bit ones are loaded
// and converted by the thread.  The storage types are launch parameters,
// not template ones, so each reconstruction costs one kernel here.  The
// float32 ensemble (a float32 carry, unscaled, float32 strips, prescaled
// sym rows: only the member fold) takes instances of its own, where those
// settings are compile-time constants (storage<true>): its loads, stores and
// sym rows compile to cov_stage.cu's, with none of the decode, 16-bit or
// frame branches left in the code.

#include "cov_faces.cuh"

namespace {

using namespace cov;

struct Params {
  const void* h0;    // (6B, n, n) stage base (hcode), read only if with_y0
  const void* u0;    // (2, 6B, n, n) (ucode)
  const void* hc;    // (6B, n, n) current stage (hcode)
  const void* uc;    // (2, 6B, n, n) (ucode)
  const void* gsn;   // (6B, 6h+2, n) routed S/N ghosts + sym rows (s16)
  const void* gwe;   // (6B, n, 6h+2) routed W/E ghosts + sym columns (s16)
  const float* b;    // (6, m, m) orography, ghosts filled
  const float* xc;   // (m,) tan of the cell-center coordinates
  const float* xf;   // (m,) tan of the left-face coordinates
  const float* fz;   // (6, 3) face-frame z components (c0, cx, cy)
  void* ho;          // (6B, n, n) (hcode)
  void* uo;          // (2, 6B, n, n) (ucode)
  void* ssn;         // (6B, 6h, n) (s16)
  void* swe;         // (6B, n, 6h) (s16)
  int n, halo, with_y0, members, hcode, ucode, s16, frame;
  float R2, gravity, two_omega, inv2d, inv_d, a, bcoef, g_dt_h, g_dt_u;
  float h_scale, h_off, u_scale;
};

// The carry and strip settings of a launch: the launch's own, or (RAW,
// the COV_POLICY_MEMBERS instances) the float32 ensemble's as constants.
struct Storage {
  int hcode, ucode, s16, frame;
  float h_scale, h_off, u_scale;
};

template <bool RAW>
__device__ __forceinline__ Storage storage(const Params& p) {
  if constexpr (RAW)
    return {CarryF32, CarryF32, 0, 0, 1.0f, 0.0f, 1.0f};
  else
    return {p.hcode, p.ucode, p.s16, p.frame, p.h_scale, p.h_off, p.u_scale};
}

template <class R>
struct Smem {
  StageWindowR<R> w[2];   // this face's window and the next one's
  StageMetric mt;
  StageScratch s;
  SymBuf sym;             // this face's sym rows (bfloat16 or frame)
};

// The stored value at element idx of a carried field, decoded: widened,
// times scale where it is not 1, plus off where it is not 0.
__device__ __forceinline__ float decode(const void* q, long idx, int code,
                                        float scale, float off) {
  float x = carry_load(q, idx, code);
  if (scale != 1.0f) x = x * scale;
  if (off != 0.0f) x = x + off;
  return x;
}

// Issues the copies of rows jw .. jw+ROWS-1, columns i0-A .. i0+FTX+A-1
// of field fi of one face into s (row stride S, tile column c at s[r * S
// + OFF + c]): interior cells from the carry q (elements from qf on,
// decoded), ghosts from the routed gsn / gwe (elements from gf on), 0
// elsewhere.
template <int ROWS, int A, int S = WS, int OFF = WOFF>
__device__ __forceinline__ void stage_carry(
    float* s, const void* q, long qf, int code, float scale, float off,
    const void* gsn, const void* gwe, long gf, int s16, int fi, int n,
    int hh, int jw, int i0) {
  const int rw = 6 * hh + 2;
  const bool raw = code == CarryF32 && scale == 1.0f && off == 0.0f;
  for_region<ROWS, FTX + 2 * A>([&](int r, int cc) {
    const int c = cc - A;
    float* dst = s + r * S + OFF + c;
    long g = 0;
    const int kind = edge_kind(fi, n, hh, rw, jw + r, i0 + c, g);
    if (kind == 0) {
      const long idx = qf + (long)(jw + r) * n + i0 + c;
      if (raw)
        async_copy4(dst, static_cast<const float*>(q) + idx);
      else
        *dst = decode(q, idx, code, scale, off);
    } else if (kind < 0) {
      *dst = 0.0f;
    } else {
      const void* src = kind == 1 ? gsn : gwe;
      if (s16)
        *dst = strip_load(src, gf + g, 1);
      else
        async_copy4(dst, static_cast<const float*>(src) + gf + g);
    }
  });
}

// Issues the copies of face f's window (static face fs) into w.
template <class R, bool RAW>
__device__ __forceinline__ void stage_window(const Params& p,
                                             StageWindowR<R>& w, int f,
                                             int fs, int j0, int i0) {
  constexpr int A = R::A;
  const Storage st = storage<RAW>(p);
  const int n = p.n, hh = p.halo, m = n + 2 * hh, rw = 6 * hh + 2;
  const long nn = (long)n * n, un = 6L * p.members * nn;
  const long gf = (long)f * rw * n;
  stage_carry<FTY + 2 * A, A, FTX + 2 * A, A>(
      &w.h[0][0], p.hc, f * nn, st.hcode, st.h_scale, st.h_off, p.gsn,
      p.gwe, gf, st.s16, 0, n, hh, j0 - A, i0);
  stage_carry<FTY + 2, 1>(&w.ua[0][0], p.uc, f * nn, st.ucode, st.u_scale,
                          0.0f, p.gsn, p.gwe, gf, st.s16, 1, n, hh, j0 - 1,
                          i0);
  stage_carry<FTY + 2, 1>(&w.ub[0][0], p.uc, un + f * nn, st.ucode,
                          st.u_scale, 0.0f, p.gsn, p.gwe, gf, st.s16, 2, n,
                          hh, j0 - 1, i0);
  stage_band(w.b, p.b + (long)fs * m * m, n, hh, j0, i0);
}

// p + idx elements of esz bytes.
__device__ __forceinline__ void* elem(void* p, long idx, int esz) {
  return static_cast<char*>(p) + idx * esz;
}

template <class R, bool RAW>
__device__ __forceinline__ void stage_faces(const Params& p, Smem<R>& sm,
                                            int f0, int j0, int i0) {
  const int n = p.n, hh = p.halo, rw = 6 * hh + 2;
  const long nn = (long)n * n, un = 6L * p.members * nn;
  const int lx = threadIdx.x;
  const int fs0 = f0 % 6;   // a group's three faces are one member's
  const Storage st = storage<RAW>(p);
  const int esz = st.s16 ? 2 : 4;
  const bool hraw = st.hcode == CarryF32 && st.h_scale == 1.0f
                    && st.h_off == 0.0f;
  const bool uraw = st.ucode == CarryF32 && st.u_scale == 1.0f;
  const StageConsts k{p.R2, p.gravity, p.two_omega, p.inv2d, p.inv_d};
  const bool strips = j0 < hh || i0 < hh || j0 + FTY > n - hh
                      || i0 + FTX > n - hh;

  stage_window<R, RAW>(p, sm.w[0], f0, fs0, j0, i0);
  async_commit();
  stage_metric(sm.mt, p.xc, p.xf, p.xc, p.xf, p.R2, p.inv_d, n, hh, j0, i0);

  for (int q = 0; q < FPB; ++q) {
    const int f = f0 + q, fs = fs0 + q, cur = q & 1;
    if (q + 1 < FPB) {
      stage_window<R, RAW>(p, sm.w[cur ^ 1], f + 1, fs + 1, j0, i0);
      async_commit();
      async_wait<1>();
    } else {
      async_wait<0>();
    }
    // The combine's y0 (stored space) at the thread's cells.
    float y0[FTY / BY][3] = {};
    if (p.with_y0) {
#pragma unroll
      for (int r = 0; r < FTY / BY; ++r) {
        const int j = j0 + threadIdx.y + r * BY, i = i0 + lx;
        if (j < n && i < n) {
          const long c = f * nn + (long)j * n + i;
          y0[r][0] = carry_load(p.h0, c, st.hcode);
          y0[r][1] = carry_load(p.u0, c, st.ucode);
          y0[r][2] = carry_load(p.u0, un + c, st.ucode);
        }
      }
    }
    const long gf = (long)f * rw * n;
    const SymRows sym =
        st.s16 || st.frame
            ? sym_rows_buf(sm.sym, elem(const_cast<void*>(p.gsn), gf, esz),
                           elem(const_cast<void*>(p.gwe), gf, esz), st.s16,
                           st.frame, p.xc, p.xf, p.R2, n, hh, j0, i0)
            : routed_sym(static_cast<const float*>(p.gsn) + gf,
                         static_cast<const float*>(p.gwe) + gf, n, hh);
    __syncthreads();   // this face's window (and, first, mt) complete

    const StageWindowR<R>& w = sm.w[cur];
    void* ssn = elem(p.ssn, (long)f * 6 * hh * n, esz);
    void* swe = elem(p.swe, (long)f * n * 6 * hh, esz);
    stage_face_tile<Seam::Prescaled>(
        w, sm.mt, sm.s, sym, p.xc, p.xf, p.xc, p.xf, p.fz + 3 * fs, k, n,
        hh, j0, i0,
        [&](int r, int j, int i, float dh, float dua, float dub, float hcv,
            float uav, float ubv) {
          const long c = f * nn + (long)j * n + i;
          // The current values in stored space.
          const float yh = hraw ? hcv : carry_load(p.hc, c, st.hcode);
          const float ya = uraw ? uav : carry_load(p.uc, c, st.ucode);
          const float yb = uraw ? ubv : carry_load(p.uc, un + c, st.ucode);
          float v[3] = {
              combine(p.with_y0, p.a, p.bcoef, p.g_dt_h, y0[r][0], yh, dh),
              combine(p.with_y0, p.a, p.bcoef, p.g_dt_u, y0[r][1], ya, dua),
              combine(p.with_y0, p.a, p.bcoef, p.g_dt_u, y0[r][2], yb,
                      dub)};
          carry_store(p.ho, c, st.hcode, v[0]);
          carry_store(p.uo, c, st.ucode, v[1]);
          carry_store(p.uo, un + c, st.ucode, v[2]);
          if (strips) {
            // The strips in absolute units.
            if (st.h_scale != 1.0f) v[0] = v[0] * st.h_scale;
            if (st.h_off != 0.0f) v[0] = v[0] + st.h_off;
            if (st.u_scale != 1.0f) {
              v[1] = v[1] * st.u_scale;
              v[2] = v[2] * st.u_scale;
            }
            for (int fi = 0; fi < 3; ++fi)
              put_strips_rt(ssn, swe, st.s16, fi, n, hh, j, i, v[fi]);
          }
        });
    __syncthreads();   // w, the scratch and sym are free for the next face
  }
}

template <class R, bool RAW = false>
__device__ __forceinline__ void stage_block(const Params& p) {
  extern __shared__ float smem_raw[];
  Smem<R>& sm = *reinterpret_cast<Smem<R>*>(smem_raw);
  stage_faces<R, RAW>(p, sm, blockIdx.z * FPB, blockIdx.y * FTY,
                      blockIdx.x * FTX);
}

#if defined(COV_POLICY_MEMBERS)
// The float32 ensemble (RAW): float32 arithmetic, every
// reconstruction.
__global__ void __launch_bounds__(NT, 3)
cov_stage_members_kernel_mc(const Params p) {
  stage_block<PlrMc, true>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_stage_members_kernel_none(const Params p) {
  stage_block<Plr<SlopeNone>, true>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_stage_members_kernel_minmod(const Params p) {
  stage_block<Plr<SlopeMinmod>, true>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_stage_members_kernel_mc_sign(const Params p) {
  stage_block<Plr<SlopeMcSign>, true>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_stage_members_kernel_vanleer(const Params p) {
  stage_block<Plr<SlopeVanleer>, true>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_stage_members_kernel_ppm(const Params p) {
  stage_block<Ppm, true>(p);
}
#elif !defined(COV_POLICY_BF16)
// Float32 arithmetic, every reconstruction.
__global__ void __launch_bounds__(NT, 3)
cov_stage_policy_kernel_mc(const Params p) {
  stage_block<PlrMc>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_stage_policy_kernel_none(const Params p) {
  stage_block<Plr<SlopeNone>>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_stage_policy_kernel_minmod(const Params p) {
  stage_block<Plr<SlopeMinmod>>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_stage_policy_kernel_mc_sign(const Params p) {
  stage_block<Plr<SlopeMcSign>>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_stage_policy_kernel_vanleer(const Params p) {
  stage_block<Plr<SlopeVanleer>>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_stage_policy_kernel_ppm(const Params p) {
  stage_block<Ppm>(p);
}
#else
// The bf16 compute policy, the PLR limiters.
__global__ void __launch_bounds__(NT, 3)
cov_stage_policy_bf16_kernel_mc(const Params p) {
  stage_block<PlrLo<SlopeMcLo>>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_stage_policy_bf16_kernel_none(const Params p) {
  stage_block<PlrLo<SlopeNoneLo>>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_stage_policy_bf16_kernel_minmod(const Params p) {
  stage_block<PlrLo<SlopeMinmodLo>>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_stage_policy_bf16_kernel_mc_sign(const Params p) {
  stage_block<PlrLo<SlopeMcSignLo>>(p);
}
__global__ void __launch_bounds__(NT, 3)
cov_stage_policy_bf16_kernel_vanleer(const Params p) {
  stage_block<PlrLo<SlopeVanleerLo>>(p);
}
#endif

// Launches kernel (the instance of policy R) on `stream`.
template <class R>
int launch(void (*kernel)(Params), const Params& p, void* stream) {
  const int rc = dynamic_smem_limit<R>(kernel, sizeof(Smem<R>));
  if (rc != 0) return rc;
  const int n = p.n;
  const dim3 grid((n + FTX - 1) / FTX, (n + FTY - 1) / FTY,
                  6 * p.members / FPB);
  const dim3 block(BX, BY);
  const size_t smem = sizeof(Smem<R>);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch one stage on `stream`; each returns the cudaError_t of the shared
// memory attribute or of the launch (0 = ok).  with_y0 == 0: yc +
// g_dt*L (stage 1); with_y0 != 0: (a*y0 + b*yc) + g_dt*L (stages 2-3; h0
// / u0 read only then), in stored space, g_dt_h / g_dt_u the tendency
// constants of h and u.  Tensors contiguous, in the layouts of Params:
// the carry of types hcode / ucode, the ghosts and strips float32 or
// (s16) bfloat16, b / xc / xf / fz float32; frame: the sym rows are
// un-prescaled.  cov_stage_policy_<mode>_f32
// runs float32 arithmetic, cov_stage_policy_<mode>_bf16 the bf16 compute
// policy (PLR only); cov_stage_members_<mode>_f32 (cov_stage_members.cu)
// the float32 ensemble, whose carry and strip arguments must be the
// float32 ones (hcode = ucode = 0, s16 = frame = 0, scales 1, offset 0).
#define COV_POLICY_ENTRY(NAME, KERNEL, POLICY)                              \
  extern "C" int NAME(                                                      \
      const void* h0, const void* u0, const void* hc, const void* uc,       \
      const void* gsn, const void* gwe, const float* b_ext,                 \
      const float* xc, const float* xf, const float* fz, void* ho,          \
      void* uo, void* ssn, void* swe, int n, int halo, int with_y0,         \
      int members, int hcode, int ucode, int s16, int frame, float R2,      \
      float gravity,                                                        \
      float two_omega, float inv2d, float inv_d, float a, float b,          \
      float g_dt_h, float g_dt_u, float h_scale, float h_off,               \
      float u_scale, void* stream) {                                        \
    const Params p{h0, u0, hc, uc, gsn, gwe, b_ext, xc, xf, fz, ho, uo,     \
                   ssn, swe, n, halo, with_y0, members, hcode, ucode, s16,  \
                   frame,                                                   \
                   R2, gravity, two_omega, inv2d, inv_d, a, b, g_dt_h,      \
                   g_dt_u, h_scale, h_off, u_scale};                        \
    return launch<POLICY>(KERNEL, p, stream);                               \
  }

#if defined(COV_POLICY_MEMBERS)
COV_POLICY_ENTRY(cov_stage_members_mc_f32, cov_stage_members_kernel_mc,
                 PlrMc)
COV_POLICY_ENTRY(cov_stage_members_none_f32, cov_stage_members_kernel_none,
                 Plr<SlopeNone>)
COV_POLICY_ENTRY(cov_stage_members_minmod_f32,
                 cov_stage_members_kernel_minmod, Plr<SlopeMinmod>)
COV_POLICY_ENTRY(cov_stage_members_mc_sign_f32,
                 cov_stage_members_kernel_mc_sign, Plr<SlopeMcSign>)
COV_POLICY_ENTRY(cov_stage_members_vanleer_f32,
                 cov_stage_members_kernel_vanleer, Plr<SlopeVanleer>)
COV_POLICY_ENTRY(cov_stage_members_ppm_f32, cov_stage_members_kernel_ppm,
                 Ppm)
#elif !defined(COV_POLICY_BF16)
COV_POLICY_ENTRY(cov_stage_policy_mc_f32, cov_stage_policy_kernel_mc, PlrMc)
COV_POLICY_ENTRY(cov_stage_policy_none_f32, cov_stage_policy_kernel_none,
                 Plr<SlopeNone>)
COV_POLICY_ENTRY(cov_stage_policy_minmod_f32, cov_stage_policy_kernel_minmod,
                 Plr<SlopeMinmod>)
COV_POLICY_ENTRY(cov_stage_policy_mc_sign_f32,
                 cov_stage_policy_kernel_mc_sign, Plr<SlopeMcSign>)
COV_POLICY_ENTRY(cov_stage_policy_vanleer_f32,
                 cov_stage_policy_kernel_vanleer, Plr<SlopeVanleer>)
COV_POLICY_ENTRY(cov_stage_policy_ppm_f32, cov_stage_policy_kernel_ppm, Ppm)
#else
COV_POLICY_ENTRY(cov_stage_policy_mc_bf16, cov_stage_policy_bf16_kernel_mc,
                 PlrLo<SlopeMcLo>)
COV_POLICY_ENTRY(cov_stage_policy_none_bf16,
                 cov_stage_policy_bf16_kernel_none, PlrLo<SlopeNoneLo>)
COV_POLICY_ENTRY(cov_stage_policy_minmod_bf16,
                 cov_stage_policy_bf16_kernel_minmod, PlrLo<SlopeMinmodLo>)
COV_POLICY_ENTRY(cov_stage_policy_mc_sign_bf16,
                 cov_stage_policy_bf16_kernel_mc_sign, PlrLo<SlopeMcSignLo>)
COV_POLICY_ENTRY(cov_stage_policy_vanleer_bf16,
                 cov_stage_policy_bf16_kernel_vanleer,
                 PlrLo<SlopeVanleerLo>)
#endif
