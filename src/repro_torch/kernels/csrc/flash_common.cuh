// What the flash attention kernels share: their arguments, the walk of
// the 2-simplex of (q tile, kv tile) pairs, and cp.async helpers.
//
// flash_attention.cu runs the float32 mma.sync kernel below 64-row
// tiles, flash_wgmma.cu (float32) and flash16_wgmma.cu (bfloat16,
// float16) the kernels on wgmma at 64- and 128-row tiles, and
// flash16_stacked.cu the 16-bit kernel on wgmma below 64-row tiles, with
// the heads of a GQA group stacked in a warpgroup's 64 rows (its blocks
// take several heads; see there).  All walk the schedule the same way: one block per
// (b*Hq, pair p) for the folded schedule walks j = 0..nq:
//   j <= p: (q, kv) = (p, j);  j > p: (q, kv) = (nq-1-p, j-p-1),
// resetting at j == 0 | j == p+1 and flushing at j == p | j == nq, so
// each query tile's KV visits are consecutive and every block does
// nq+1 tile steps (an odd nq's middle pair recomputes and rewrites its
// own tile).  The bounding-box schedule has one block per (b*Hq, q tile)
// and walks its kv <= q tiles.  The KV row of bh is bh / (Hq/Hkv).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FLASH_NEG_INF (-1e30f)

struct FlashArgs {
  const void* q;      // (B*Hq, S, D) of the input type
  const void* k;      // (B*Hkv, S, D)
  const void* v;      // (B*Hkv, S, D)
  void* o;            // (B*Hq, S, D), q's type
  const float* bias;  // (bias_b*bias_h, S, S) float32, or null
  const int* seg;     // (B, S) or null
  int hq, group, s, nq, bias_b, bias_h, folded;
  float scale;
};

// The arguments of flash_attention_launch, flash_wgmma_launch,
// flash16_wgmma_launch and flash16_stacked_launch, checked; blocks is
// one per (b*Hq, pair row).
static inline bool flash_args(FlashArgs* a, void* o, const void* q, const void* k,
                              const void* v, const void* bias, int bias_b, int bias_h,
                              const void* seg, int b, int hq, int hkv, int s, int block_q,
                              int folded, float scale, long long* blocks) {
  if (b < 1 || hkv < 1 || hq % hkv || block_q < 1 || s % block_q) return false;
  a->q = q;
  a->k = k;
  a->v = v;
  a->o = o;
  a->bias = (const float*)bias;
  a->seg = (const int*)seg;
  a->hq = hq;
  a->group = hq / hkv;
  a->s = s;
  a->nq = s / block_q;
  a->bias_b = bias_b;
  a->bias_h = bias_h;
  a->folded = folded;
  a->scale = scale;
  const long long pairs = folded ? (a->nq + 1) / 2 : a->nq;
  *blocks = (long long)b * hq * pairs;
  return *blocks <= 0x7fffffffLL;
}

static __device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// The same copy of `bytes` (0 or 16) bytes from src, the rest of the 16
// zero-filled: a key row past the sequence lands as zeros.
static __device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

static __device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Step j of row p: (q tile, kv tile, reset, flush).
static __device__ __forceinline__ void flash_step(const FlashArgs& a, int p, int j, int& qt,
                                                  int& kt, bool& start, bool& last) {
  if (a.folded) {
    const bool second = j > p;
    qt = second ? a.nq - 1 - p : p;
    kt = second ? j - p - 1 : j;
    start = j == 0 || j == p + 1;
    last = j == p || j == a.nq;
  } else {  // bounding box: the live steps kv = 0..p of q tile p
    qt = p;
    kt = j;
    start = j == 0;
    last = j == p;
  }
}

// The block's slab: its bh, pair row p, KV row, batch, bias slab and
// segment row.
struct FlashSlab {
  long long bh, kvh, batch;
  int p, steps;
  const float* bias;
  const int* seg;
};

static __device__ __forceinline__ FlashSlab flash_slab(const FlashArgs& a) {
  FlashSlab sl;
  const int pairs = a.folded ? (a.nq + 1) / 2 : a.nq;
  sl.bh = blockIdx.x / pairs;
  sl.p = (int)(blockIdx.x % pairs);
  sl.kvh = sl.bh / a.group;
  sl.batch = sl.bh / a.hq;
  sl.steps = a.folded ? a.nq + 1 : sl.p + 1;
  sl.bias = nullptr;
  if (a.bias) {
    const long long head = sl.bh % a.hq;
    const long long sb = a.bias_b > 1 ? sl.batch % a.bias_b : 0;
    const long long sh = a.bias_h > 1 ? head % a.bias_h : 0;
    sl.bias = a.bias + (sb * a.bias_h + sh) * a.s * (long long)a.s;
  }
  sl.seg = a.seg ? a.seg + sl.batch * a.s : nullptr;
  return sl;
}

// One sub-chunk's scores through the mask and the online softmax, as
// flash and flash_wgmma hold them (the 16-bit kernels have their own, in
// wgmma16.cuh): sc[nt][e] is row rl0 (e < 2) or rl0 + 8 of the tile,
// tile-local key cbase + 8 nt + 2t + (e & 1).  The scores are
// scaled by `scale` (both pass 1: their Q is scaled before the product), the
// bias added, the causal and segment masks and the rows past the tile
// (block 8 pads a warp's 16 rows) applied; then the row max over the
// quad, alpha = exp(old max - new max), the probabilities (masked ones
// 0, so a row with no visible key keeps l = 0) in place of the scores,
// and the lane's part of each row's denominator.
template <int NKT>
static __device__ __forceinline__ void flash_softmax(float (*sc)[4], float scale,
                                                     const FlashArgs& a, const FlashSlab& sl,
                                                     int block, int qt, int kt, int rl0,
                                                     int cbase, int t, float* mrow, float* lrow,
                                                     float* alpha) {
  const int rl1 = rl0 + 8;
  const bool diag = qt == kt;
  // Below the diagonal, with no bias or segments, every score is visible.
  const bool dense = block >= 16 && !diag && !sl.seg && !sl.bias;
  unsigned valid = dense ? ~0u : 0u;
  float mx[2] = {FLASH_NEG_INF, FLASH_NEG_INF};
#pragma unroll
  for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[nt][e] * scale;
      if (!dense) {
        const int rl = e < 2 ? rl0 : rl1;
        const int cl = cbase + nt * 8 + 2 * t + (e & 1);
        bool ok = rl < block && !(diag && cl > rl);
        const int row = qt * block + rl, col = kt * block + cl;
        if (ok && sl.seg) ok = sl.seg[row] == sl.seg[col];
        if (ok && sl.bias) x += sl.bias[(long long)row * a.s + col];
        x = ok ? x : FLASH_NEG_INF;
        if (ok) valid |= 1u << (nt * 4 + e);
      }
      sc[nt][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float mn[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    mn[h] = fmaxf(mrow[h], mx[h]);
    alpha[h] = expf(mrow[h] - mn[h]);
    mrow[h] = mn[h];
  }
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pr = (valid >> (nt * 4 + e)) & 1u ? expf(sc[nt][e] - mn[e >> 1]) : 0.f;
      sc[nt][e] = pr;
      ps[e >> 1] += pr;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) lrow[h] = lrow[h] * alpha[h] + ps[h];
}

// Whether any row of the warp moved its max (O must be rescaled).
static __device__ __forceinline__ bool flash_moved(const float* alpha) {
  return !__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f);
}

// P of the 16-bit kernels as two parts of the input type, hi = round(P)
// and lo = round(P - hi), two floats packed a pair (element a in the low
// half, the lower column), and the output's rounding.
template <typename T>
struct Flash16Parts;

template <>
struct Flash16Parts<__nv_bfloat16> {
  static __device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const __nv_bfloat162 l =
        __floats2bfloat162_rn(a - __low2float(h), b - __high2float(h));
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  }
  static __device__ __forceinline__ uint32_t pack(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
};

template <>
struct Flash16Parts<__half> {
  static __device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
    const __half2 h = __floats2half2_rn(a, b);
    const __half2 l = __floats2half2_rn(a - __low2float(h), b - __high2float(h));
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  }
  static __device__ __forceinline__ uint32_t pack(float a, float b) {
    const __half2 h = __floats2half2_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
};
