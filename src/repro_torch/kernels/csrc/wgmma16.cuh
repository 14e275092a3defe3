// What the 16-bit flash kernels on warpgroup MMA share (flash16_wgmma.cu
// at 64- and 128-row tiles, flash16_stacked.cu at 8-32-row tiles with
// the GQA group's heads stacked): the operand layout in wgmma's 128-byte
// swizzle, the descriptors, the wgmma instructions in bf16 and f16, S of
// one key chunk, O += lo V + hi V of one chunk, and the online softmax in
// the log2 domain.
//
// Layout: Q, K and V in shared memory as they are, rows of 128 bytes (64
// elements), 8-row atoms of 1024 bytes, the 16-byte piece c of row r at
// piece (c % 8) ^ (r % 8), atoms along D at a stride of rows * 128 bytes
// (f16_swz).  D < 64 fills part of one atom.  Q and K are K-major
// operands of S; V, stored the same way ([key][d]), is the MN-major B
// operand of PV through the transpose-B immediate that 16-bit wgmma has.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

#define F16_BN 64     // keys a chunk
#define F16_STAGES 3  // chunks in the ring

// Byte offset of 16-byte piece c (8 elements) of row r in an operand of
// `rows` rows in the 128-byte swizzle: atom c / 8 holds rows x 128 bytes.
static __device__ __forceinline__ int f16_swz(int r, int c, int rows) {
  return (c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

static __device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// wgmma descriptors in the 128-byte swizzle (layout type 1): the start
// address, the leading byte offset (LBO) and the stride byte offset
// (SBO), each in 16-byte units.  K-major (Q, K): SBO 1024 between 8-row
// groups; LBO is not used.  MN-major (V as [key][d]): LBO between the
// 64-column atoms along N, SBO 1024 between 8-key groups along K.
static __device__ __forceinline__ uint64_t f16_desc(const void* p, uint32_t lbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

static __device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
static __device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
static __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// After a wait: the registers an asynchronous wgmma read or wrote are
// live and current here, so the compiler neither reuses nor reads them
// early.
template <int N>
static __device__ __forceinline__ void wg_pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
static __device__ __forceinline__ void wg_pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int f = 0; f < 4; ++f) asm volatile("" : "+r"(r[i][f])::"memory");
}
static __device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
template <int N>
static __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// --- wgmma in bf16 / f16 ----------------------------------------------------

#define WG16_R32                                                                           \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WG16_R64                                                                         \
  WG16_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "   \
           "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, " \
           "%61, %62, %63"
#define WG16_O32(d)                                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),     \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),          \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),       \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])
#define WG16_O64(d)                                                                        \
  WG16_O32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),           \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),       \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),       \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),       \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),       \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// ss: S (64 x 64) from two K-major shared-memory operands, scale_d = 0
// overwrites d.  rs64 / rs128: O (64 x N) += A (the warp's 16 rows from
// registers, the m16n8k16 A fragment) times B read MN-major (the
// transpose-B immediate 1).
template <typename T>
struct Wg16;

#define WG16_DEFINE(T, TY)                                                                 \
  template <>                                                                              \
  struct Wg16<T> {                                                                         \
    static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db,          \
                                              int scale_d) {                               \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                            \
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" WG16_R32   \
                   "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                      \
                   : WG16_O32(d)                                                           \
                   : "l"(da), "l"(db), "r"(scale_d));                                      \
    }                                                                                      \
    static __device__ __forceinline__ void rs64(float* d, const uint32_t* a, uint64_t db,  \
                                                int scale_d) {                             \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                            \
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" WG16_R32   \
                   "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                        \
                   : WG16_O32(d)                                                           \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));   \
    }                                                                                      \
    static __device__ __forceinline__ void rs128(float* d, const uint32_t* a, uint64_t db, \
                                                 int scale_d) {                            \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                            \
                   "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" WG16_R64  \
                   "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                        \
                   : WG16_O64(d)                                                           \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));   \
    }                                                                                      \
  };

WG16_DEFINE(__nv_bfloat16, "bf16")
WG16_DEFINE(__half, "f16")
#undef WG16_DEFINE

// S = Q K^T of one F16_BN-key chunk (kc) for warpgroup wg, committed as
// one group: D/16 k-steps of 32 bytes, atom ks / 4 of each row, both
// operands K-major; Q has QROWS rows, the warpgroup's 64 from row 64 wg.
// The first wgmma has scale_d = 0 and overwrites sc.
template <typename W, int D, int QROWS>
static __device__ __forceinline__ void qk16(float* sc, const unsigned char* q_s,
                                            const unsigned char* kc, int wg) {
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int qo = (ks >> 2) * QROWS * 128 + wg * 64 * 128 + (ks & 3) * 32;
    const int ko = (ks >> 2) * F16_BN * 128 + (ks & 3) * 32;
    W::ss(sc, f16_desc(q_s + qo, 16), f16_desc(kc + ko, 16), ks > 0);
  }
  wg_commit();
}

// O += lo V + hi V over one 64-key chunk of V (vc), committed as one
// group: V's keys 16j..16j+15 are two 8-key groups from byte 2048 j.
template <typename W, int NV>
static __device__ __forceinline__ void pv(float* o, const uint32_t (*hi)[4],
                                          const uint32_t (*lo)[4], const unsigned char* vc) {
#pragma unroll
  for (int j = 0; j < F16_BN / 16; ++j) {
    const uint64_t dv = f16_desc(vc + j * 16 * 128, F16_BN * 128);
    if constexpr (NV == 64) {
      W::rs64(o, lo[j], dv, 1);
      W::rs64(o, hi[j], dv, 1);
    } else {
      W::rs128(o, lo[j], dv, 1);
      W::rs128(o, hi[j], dv, 1);
    }
  }
  wg_commit();
}

// P's parts as the A fragment of k-step j: register f holds row g
// (f even) or g+8, keys 16j + 8(f / 2) + 2t, +1 = sc[8j + 2f], sc[8j + 2f + 1].
template <typename T>
static __device__ __forceinline__ void p_parts(const float* sc, uint32_t (*hi)[4],
                                               uint32_t (*lo)[4]) {
#pragma unroll
  for (int j = 0; j < F16_BN / 16; ++j)
#pragma unroll
    for (int f = 0; f < 4; ++f)
      Flash16Parts<T>::split2(sc[8 * j + 2 * f], sc[8 * j + 2 * f + 1], hi[j][f], lo[j][f]);
}

// --- the softmax --------------------------------------------------------------

static __device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one 64-key chunk's masked scores, in the log2
// domain: sc holds x = (s * scale + bias) * log2(e) (FLASH_NEG_INF where
// masked; bit i of valid set where sc[i] is visible), and P = 2^(x - max)
// replaces it, so each probability is one ex2 (flash_softmax's expf is a
// dozen instructions, and this elementwise work, not the MMAs, bounds
// the kernels).  ex2.approx is within 2 ulp of float32, far below the
// 16-bit output's rounding.  sc[4i + e] is the lane's row rl0 (e < 2) or
// rl0 + 8, key 8i + 2t + (e & 1) of the chunk; mrow holds the row max in
// log2 units.  Masked probabilities are 0, so a row with no visible key
// keeps l = 0.  Row max and sums are trees, not chains.
static __device__ __forceinline__ void online16(float* sc, unsigned valid, float* mrow,
                                                float* lrow, float* alpha) {
  constexpr int N = F16_BN / 2;  // scores a thread
  float mx[2][N / 4];            // [row half][partial]
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    mx[0][i] = fmaxf(sc[4 * i], sc[4 * i + 1]);
    mx[1][i] = fmaxf(sc[4 * i + 2], sc[4 * i + 3]);
  }
#pragma unroll
  for (int w = N / 8; w >= 1; w >>= 1)
#pragma unroll
    for (int i = 0; i < w; ++i) {
      mx[0][i] = fmaxf(mx[0][i], mx[0][i + w]);
      mx[1][i] = fmaxf(mx[1][i], mx[1][i + w]);
    }
  float mn[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float m = mx[h][0];
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    mn[h] = fmaxf(mrow[h], m);
    alpha[h] = ex2(mrow[h] - mn[h]);
    mrow[h] = mn[h];
  }
  float ps[2][N / 4];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float pr = (valid >> i) & 1u ? ex2(sc[i] - mn[(i >> 1) & 1]) : 0.f;
    sc[i] = pr;
    if ((i & 1) == 0)
      ps[(i >> 1) & 1][i >> 2] = pr;
    else
      ps[(i >> 1) & 1][i >> 2] += pr;
  }
#pragma unroll
  for (int w = N / 8; w >= 1; w >>= 1)
#pragma unroll
    for (int i = 0; i < w; ++i) {
      ps[0][i] += ps[0][i + w];
      ps[1][i] += ps[1][i + w];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) lrow[h] = lrow[h] * alpha[h] + ps[h][0];
}
