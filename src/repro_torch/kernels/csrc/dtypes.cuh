// Element types of the simplex kernels (accum.cu, ca.cu, edm.cu,
// legacy2d.cu, legacy_md.cu) and the arithmetic each does in them.
//
// The reference's kernel bodies are dtype-generic: ACCUM adds 1 in the
// array's own type, CA counts neighbours in the state's own type and
// casts its 0/1 result back, EDM computes in float32 and stores in the
// points' type.  Dt<T> gives each kernel that arithmetic as torch, numpy
// and JAX do it:
//
// - integers wrap (int8 127 + 1 == -128): the add runs in the unsigned
//   type of the same width, since signed overflow is undefined in C++,
//   and the conversion back is modular;
// - bfloat16 and float16 widen to float32, add there and round to
//   nearest even.  float32 holds at least 2p + 2 bits of either type
//   (p = 8 and 11), so the double rounding is exact: the result is the
//   correctly rounded 16-bit sum, as torch's x + 1 gives it;
// - float32 and float64 add in their own type.
//
// The dtype codes are kernels/policy.py DTYPE_CODES.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum SimplexDtype {
  SIMPLEX_I32 = 0,
  SIMPLEX_I64 = 1,
  SIMPLEX_F32 = 2,
  SIMPLEX_F64 = 3,
  SIMPLEX_I8 = 4,
  SIMPLEX_U8 = 5,
  SIMPLEX_I16 = 6,
  SIMPLEX_BF16 = 7,
  SIMPLEX_F16 = 8,
};

// float and double: their own arithmetic.
template <typename T>
struct Dt {
  static __device__ __forceinline__ T add(T a, T b) { return a + b; }
  static __device__ __forceinline__ T from_float(float v) { return (T)v; }
  static __device__ __forceinline__ bool eq(T a, int v) { return a == (T)v; }
};

// Integers: modular adds in the unsigned type of the same width.
#define SIMPLEX_DT_INT(T, U)                                                          \
  template <>                                                                         \
  struct Dt<T> {                                                                      \
    static __device__ __forceinline__ T add(T a, T b) { return (T)(U)((U)a + (U)b); } \
    static __device__ __forceinline__ T from_float(float v) { return (T)v; }          \
    static __device__ __forceinline__ bool eq(T a, int v) { return a == (T)v; }       \
  };
SIMPLEX_DT_INT(int8_t, uint8_t)
SIMPLEX_DT_INT(uint8_t, uint8_t)
SIMPLEX_DT_INT(int16_t, uint16_t)
SIMPLEX_DT_INT(int32_t, uint32_t)
SIMPLEX_DT_INT(long long, unsigned long long)
#undef SIMPLEX_DT_INT

template <>
struct Dt<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ T add(T a, T b) {
    return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
  }
  static __device__ __forceinline__ T from_float(float v) { return __float2bfloat16_rn(v); }
  static __device__ __forceinline__ bool eq(T a, int v) {
    return __bfloat162float(a) == (float)v;
  }
};

template <>
struct Dt<__half> {
  using T = __half;
  static __device__ __forceinline__ T add(T a, T b) {
    return __float2half_rn(__half2float(a) + __half2float(b));
  }
  static __device__ __forceinline__ T from_float(float v) { return __float2half_rn(v); }
  static __device__ __forceinline__ bool eq(T a, int v) { return __half2float(a) == (float)v; }
};

// Host: whether a code names a type of the family.
static inline bool dt_accum_ok(int code) { return code >= 0 && code <= 8; }
static inline bool dt_ca_ok(int code) {
  return dt_accum_ok(code) && code != SIMPLEX_F64;
}
static inline bool dt_float_ok(int code) {
  return code == SIMPLEX_F32 || code == SIMPLEX_F64 || code == SIMPLEX_BF16 ||
         code == SIMPLEX_F16;
}

// F(T) for the element type T of a code the host has checked.  The
// kernels take the code at run time and switch here, at the element: the
// code is the same in every thread, so the branch is uniform, and each
// kernel is compiled once per m rather than once per (m, type) — the
// general map it inlines is what makes a kernel slow to compile.
#define SIMPLEX_SWITCH_DTYPE(code, F)              \
  switch (code) {                                  \
    case SIMPLEX_I32: F(int32_t); break;           \
    case SIMPLEX_I64: F(long long); break;         \
    case SIMPLEX_F32: F(float); break;             \
    case SIMPLEX_F64: F(double); break;            \
    case SIMPLEX_I8: F(int8_t); break;             \
    case SIMPLEX_U8: F(uint8_t); break;            \
    case SIMPLEX_I16: F(int16_t); break;           \
    case SIMPLEX_BF16: F(__nv_bfloat16); break;    \
    default: F(__half); break;                     \
  }

// The same over the types CA takes (no float64).
#define SIMPLEX_SWITCH_CA_DTYPE(code, F)           \
  switch (code) {                                  \
    case SIMPLEX_I32: F(int32_t); break;           \
    case SIMPLEX_I64: F(long long); break;         \
    case SIMPLEX_F32: F(float); break;             \
    case SIMPLEX_I8: F(int8_t); break;             \
    case SIMPLEX_U8: F(uint8_t); break;            \
    case SIMPLEX_I16: F(int16_t); break;           \
    case SIMPLEX_BF16: F(__nv_bfloat16); break;    \
    default: F(__half); break;                     \
  }

// Bytes of one element of a code's type.
static inline int dt_bytes(int code) {
  switch (code) {
    case SIMPLEX_I64: case SIMPLEX_F64: return 8;
    case SIMPLEX_I8: case SIMPLEX_U8: return 1;
    case SIMPLEX_I16: case SIMPLEX_BF16: case SIMPLEX_F16: return 2;
    default: return 4;
  }
}

// x[off] += 1 in the type of `code` (ACCUM).
static __device__ __forceinline__ void dt_add_one(void* x, long long off, int code) {
#define SIMPLEX_ADD_ONE(T)                                   \
  {                                                          \
    T* p = static_cast<T*>(x) + off;                         \
    *p = Dt<T>::add(*p, Dt<T>::from_float(1.f));             \
  }
  SIMPLEX_SWITCH_DTYPE(code, SIMPLEX_ADD_ONE)
#undef SIMPLEX_ADD_ONE
}

// out[off] = v rounded to the floating type of `code` (EDM's stores).
static __device__ __forceinline__ void dt_store_float(void* out, long long off, int code,
                                                           float v) {
  switch (code) {
    case SIMPLEX_F64: static_cast<double*>(out)[off] = (double)v; break;
    case SIMPLEX_BF16: static_cast<__nv_bfloat16*>(out)[off] = __float2bfloat16_rn(v); break;
    case SIMPLEX_F16: static_cast<__half*>(out)[off] = __float2half_rn(v); break;
    default: static_cast<float*>(out)[off] = v; break;
  }
}
