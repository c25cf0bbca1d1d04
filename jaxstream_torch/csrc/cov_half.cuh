// 16-bit storage of the covariant kernels: bfloat16 and float16 values
// held as their bits (unsigned short) and int16 fixed point, converted to
// and from float32 with round-to-nearest-even, as PyTorch converts them.
// On the device the conversions are CUDA's intrinsics; compiled for the
// host (the emulated kernel tests) they are written out in plain C++.
//
// What uses them: the stage precision policy (bfloat16 limiter algebra,
// face-average velocities and boundary strips; bf16_round is one
// bfloat16 operation: the float32 result rounded, as PyTorch computes a
// bfloat16 op) and the 16-bit carry encodings of the compact stage
// (Carry codes below).

#pragma once

#include <cstring>

#ifdef __CUDACC__
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#endif

namespace cov {

// The storage type of a carried field, as the wrappers pass it.
enum Carry : int { CarryF32 = 0, CarryBF16 = 1, CarryF16 = 2, CarryI16 = 3 };

#ifdef __CUDACC__
__device__ __forceinline__ unsigned short f_to_bf16(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float bf16_to_f(unsigned short b) {
  return __bfloat162float(__ushort_as_bfloat16(b));
}
__device__ __forceinline__ unsigned short f_to_f16(float x) {
  return __half_as_ushort(__float2half_rn(x));
}
__device__ __forceinline__ float f16_to_f(unsigned short b) {
  return __half2float(__ushort_as_half(b));
}
// Nearest integer, ties to even, saturated to int16.
__device__ __forceinline__ short f_to_i16(float x) {
  const int r = __float2int_rn(x);
  return static_cast<short>(r < -32768 ? -32768 : (r > 32767 ? 32767 : r));
}
#else
inline unsigned short f_to_bf16(float x) {
  unsigned u;
  std::memcpy(&u, &x, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u)   // NaN stays a (quiet) NaN
    return static_cast<unsigned short>((u >> 16) | 0x40u);
  u += 0x7fffu + ((u >> 16) & 1u);
  return static_cast<unsigned short>(u >> 16);
}
inline float bf16_to_f(unsigned short b) {
  const unsigned u = static_cast<unsigned>(b) << 16;
  float x;
  std::memcpy(&x, &u, 4);
  return x;
}
inline unsigned short f_to_f16(float x) {
  const _Float16 h = static_cast<_Float16>(x);
  unsigned short b;
  std::memcpy(&b, &h, 2);
  return b;
}
inline float f16_to_f(unsigned short b) {
  _Float16 h;
  std::memcpy(&h, &b, 2);
  return static_cast<float>(h);
}
inline short f_to_i16(float x) {
  const float r = __builtin_rintf(x);
  return static_cast<short>(r < -32768.0f ? -32768
                                          : (r > 32767.0f ? 32767 : r));
}
#endif

// One bfloat16 operation's rounding of a float32 result.
__device__ __forceinline__ float bf16_round(float x) {
  return bf16_to_f(f_to_bf16(x));
}

// Element idx of a carried field of storage type code, widened.
__device__ __forceinline__ float carry_load(const void* p, long idx,
                                            int code) {
  switch (code) {
    case CarryBF16:
      return bf16_to_f(static_cast<const unsigned short*>(p)[idx]);
    case CarryF16:
      return f16_to_f(static_cast<const unsigned short*>(p)[idx]);
    case CarryI16:
      return static_cast<float>(static_cast<const short*>(p)[idx]);
    default:
      return static_cast<const float*>(p)[idx];
  }
}

// v into element idx of a carried field of storage type code.
__device__ __forceinline__ void carry_store(void* p, long idx, int code,
                                            float v) {
  switch (code) {
    case CarryBF16:
      static_cast<unsigned short*>(p)[idx] = f_to_bf16(v);
      break;
    case CarryF16:
      static_cast<unsigned short*>(p)[idx] = f_to_f16(v);
      break;
    case CarryI16:
      static_cast<short*>(p)[idx] = f_to_i16(v);
      break;
    default:
      static_cast<float*>(p)[idx] = v;
  }
}

// Element idx of a strip or routed-ghost tensor: float32, or bfloat16
// (s16) widened.
__device__ __forceinline__ float strip_load(const void* p, long idx,
                                            int s16) {
  return s16 ? bf16_to_f(static_cast<const unsigned short*>(p)[idx])
             : static_cast<const float*>(p)[idx];
}

__device__ __forceinline__ void strip_store(void* p, long idx, int s16,
                                            float v) {
  if (s16)
    static_cast<unsigned short*>(p)[idx] = f_to_bf16(v);
  else
    static_cast<float*>(p)[idx] = v;
}

}  // namespace cov
