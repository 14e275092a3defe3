// Causal flash attention forward, float32, on Hopper's warpgroup MMA:
// 64- and 128-row tiles, float32-accurate products as 3xTF32 wgmma with
// every operand split once per block, K and V landed by bulk copies on an
// mbarrier.  Float32 online softmax, GQA without a repeated K/V tensor,
// optional additive float32 bias and segment ids; the walk of the
// 2-simplex of (q tile, kv tile) pairs is flash_common.cuh's.
//
// Replaces: the TPU kernel of repro/kernels/flash_attention.py
// _flash_launch (kernel table row 5) for float32 at block_q in {64, 128}
// (flash_attention.cu keeps the smaller float32 tiles and the 16-bit
// types).
//
// Bound on the card: the products QK^T and PV, 4 * BQ * BQ * D operations
// a tile pair against 2 * BQ * D * 4 bytes of K and V, BQ / 2 operations
// a byte; at float32 accuracy on the tensor cores (3xTF32 at 495/3
// TFLOP/s, about 49 operations a byte) that is operations from BQ = 128
// up.  At the serve shape (B 4, Hq 32, S 2048, D 128) the bound is
// 0.833 ms.
//
// What the design does about the split cost.  A float32-accurate product
// splits each operand x into TF32 parts big = tf32(x), small =
// tf32(x - big) (mma_tf32.cuh's rounding) and sums small.big + big.small
// + big.big.  flash_attention.cu's float32 kernel splits every operand
// at every fragment load, by every warp: at BQ = 128 that would split
// each Q element about 68 times a tile and each K and V element once per
// warp, and on an H100 those splits cost as much as the MMAs.  Here each
// element is split once: Q once per query tile, K and V once per 32-key
// chunk by the whole block, into shared memory in the layout wgmma
// reads, and the products read the parts from there.
//
// Design (BQ / 64 consumer warpgroups, 128 or 256 threads):
// - Copies: the KV rows of one (b*Hkv) slab are contiguous in
//   (B*Hkv, S, D), so a 32-key chunk of K and one of V are two 1-D bulk
//   copies (cp.async.bulk ... mbarrier::complete_tx::bytes) into a raw
//   stage, completing on one mbarrier.  Thread 0 issues chunk i+1 as soon
//   as the block has split chunk i, so the copy runs under chunk i's
//   products.  No tensor map is needed.
// - Split pass: the block reads the raw stage and writes big and small
//   parts in wgmma's 128-byte-swizzle K-major layout (8 rows of 128 bytes
//   an atom, the 16-byte piece c of row r at c ^ (r % 8)): K as
//   [key][d], V transposed as [d][key] (for .tf32 both operands must be
//   K-major; only 16-bit types transpose in hardware).  Q is scaled and
//   split the same way at each new query tile, each warpgroup its 64
//   rows.  fence.proxy.async makes the parts visible to wgmma.
// - S = Q K^T: per warpgroup, D/8 steps of three m64n32k8 wgmmas into
//   float32 accumulators.  With N = 32 a wgmma that reads A from shared
//   memory moves more bytes than it computes, so the big part of the
//   warp's Q rows is held in registers as the A fragment of each k-step
//   (read once per query tile; D/2 registers) and serves two of the
//   three products; Q's small part and K come from shared memory.
// - Softmax on the accumulators (row g and g+8 of each warp's 16 rows,
//   columns 8i + 2t, 2t+1), as the mma.sync kernels do it.
// - O += P V: P is the A operand from registers, split in registers.
//   The accumulator holds columns (2t, 2t+1) of each 8-key block, the
//   A fragment wants (t, t+4); instead of shuffles the keys of every
//   8-key block are permuted: logical key t is physical key 2t and
//   logical t+4 is 2t+1, and the split pass writes V^T in that order, so
//   the accumulator registers are the A fragment as they stand.  Four
//   steps of three m64nDk8 wgmmas, O (64 x D) in registers.
// - Shared memory at <128, 128>: Q parts 128 KB, K parts 32 KB, V^T parts
//   32 KB, raw stage 32 KB: 225 KB, one block an SM; 204 registers a
//   thread, no spills.
//
// Unchanged semantics: online softmax in float32; O rescaled only when a
// warp's row max moved; masked probabilities zeroed, so a row with no
// visible key keeps l = 0 and gives 0, never NaN; 64-bit element offsets.
// The products drop only small.small (below 2^-22 of each term), so the
// result differs from the plain version by float32 rounding only.
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "mma_tf32.cuh"

#define WG_BN 32  // keys a chunk: one 128-byte row of V^T

// kernels/flash_attention.py flash_smem_bytes mirrors SMEM_BYTES.
template <int BQ, int D>
struct WgTile {
  static constexpr int NWG = BQ / 64;              // consumer warpgroups
  static constexpr int NT = NWG * 128;             // threads
  static constexpr int NCH = BQ / WG_BN;           // chunks a KV tile
  static constexpr int DA = (D + 31) / 32;         // 128-byte atoms along D
  static constexpr int Q_BYTES = DA * BQ * 128;    // one part of Q
  static constexpr int K_BYTES = DA * WG_BN * 128; // one part of a K chunk
  static constexpr int V_BYTES = D * 128;          // one part of V^T
  static constexpr int RAW_BYTES = WG_BN * D * 4;  // raw K (or V) chunk
  static constexpr int SMEM_BYTES =
      1024 + 2 * Q_BYTES + 2 * K_BYTES + 2 * V_BYTES + 2 * RAW_BYTES + 16;
};

// --- wgmma ----------------------------------------------------------------

// Descriptor of a K-major operand in 128-byte swizzle: 8-row groups at a
// stride of 1024 bytes (SBO); the leading offset is not used by the
// swizzled K-major layout.
static __device__ __forceinline__ uint64_t wg_desc(const void* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

static __device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
static __device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
static __device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// m64nNk8 .tf32 wgmma, float32 accumulators d (N/2 a thread): ss takes A
// from shared memory, rs from registers (the m16n8k8 A fragment of the
// warp's 16 rows); scale_d = 0 overwrites d.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15"
        "}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
          "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
          "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
          "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
          "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
          "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
          "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
          "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

// --- mbarrier and bulk copies ----------------------------------------------

static __device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

static __device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

static __device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

static __device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

static __device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                                uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

static __device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte piece c (of 4 floats) in row r of a swizzled
// K-major operand of `rows` rows: atom c / 8 holds rows x 128 bytes.
static __device__ __forceinline__ int wg_swz(int r, int c, int rows) {
  return (c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

static __device__ __forceinline__ void split4(float4 x, float4& big, float4& small) {
  uint32_t b, s;
  tf32_split(x.x, b, s);
  big.x = __uint_as_float(b);
  small.x = __uint_as_float(s);
  tf32_split(x.y, b, s);
  big.y = __uint_as_float(b);
  small.y = __uint_as_float(s);
  tf32_split(x.z, b, s);
  big.z = __uint_as_float(b);
  small.z = __uint_as_float(s);
  tf32_split(x.w, b, s);
  big.w = __uint_as_float(b);
  small.w = __uint_as_float(s);
}

// --- the kernel -------------------------------------------------------------

template <int BQ, int D>
__global__ void __launch_bounds__(WgTile<BQ, D>::NT, 1)
flash_wgmma_kernel(FlashArgs a) {
  using T = WgTile<BQ, D>;
  constexpr int NT = T::NT, NCH = T::NCH, BN = WG_BN;
  constexpr int NO = D / 2;  // O accumulators a thread
  constexpr int D4 = D / 4;  // 16-byte pieces a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Every part on a 1024-byte boundary: the swizzle atoms must be.
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_big = base;
  unsigned char* q_small = q_big + T::Q_BYTES;
  unsigned char* k_big = q_small + T::Q_BYTES;
  unsigned char* k_small = k_big + T::K_BYTES;
  unsigned char* v_big = k_small + T::K_BYTES;
  unsigned char* v_small = v_big + T::V_BYTES;
  float* k_raw = reinterpret_cast<float*>(v_small + T::V_BYTES);
  float* v_raw = k_raw + BN * D;
  uint64_t* bar = reinterpret_cast<uint64_t*>(v_raw + BN * D);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;  // warpgroup; warp within it
  const int g = lane >> 2, t = lane & 3;
  const int s = a.s;
  const FlashSlab sl = flash_slab(a);
  const float* qb = (const float*)a.q + sl.bh * s * D;
  const float* kb = (const float*)a.k + sl.kvh * s * D;
  const float* vb = (const float*)a.v + sl.kvh * s * D;
  float* ob = (float*)a.o + sl.bh * s * D;
  const int p = sl.p;
  const int items = sl.steps * NCH;  // (step, chunk) in order

  // Thread 0: the bulk copies of chunk it's K and V into the raw stage.
  auto issue = [&](int it) {
    int qt, kt;
    bool st, la;
    flash_step(a, p, it / NCH, qt, kt, st, la);
    const long long k0 = (long long)kt * BQ + (it % NCH) * BN;
    mbar_expect_tx(bar, 2 * T::RAW_BYTES);
    bulk_g2s(k_raw, kb + k0 * D, T::RAW_BYTES, bar);
    bulk_g2s(v_raw, vb + k0 * D, T::RAW_BYTES, bar);
  };
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
    issue(0);
  }
  __syncthreads();

  const int rl0 = wg * 64 + wq * 16 + g, rl1 = rl0 + 8;  // the lane's tile-local rows
  float o[NO], mrow[2], lrow[2];
  uint32_t qreg[D / 8][4];  // the big part of the warp's Q rows: the A fragment of each k-step
  for (int it = 0; it < items; ++it) {
    const int c = it % NCH;
    int qt, kt;
    bool start, last;
    flash_step(a, p, it / NCH, qt, kt, start, last);

    // Split pass: Q at a new query tile, then chunk it's K and V.
    if (start && c == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mrow[h] = FLASH_NEG_INF;
        lrow[h] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < NO; ++e) o[e] = 0.f;
      const float* qsrc = qb + (long long)qt * BQ * D;
      for (int e = tid; e < BQ * D4; e += NT) {
        const int r = e / D4, c4 = e % D4;
        float4 x = __ldg(reinterpret_cast<const float4*>(qsrc + (long long)r * D) + c4);
        x.x *= a.scale;
        x.y *= a.scale;
        x.z *= a.scale;
        x.w *= a.scale;
        float4 big, small;
        split4(x, big, small);
        const int off = wg_swz(r, c4, BQ);
        *reinterpret_cast<float4*>(q_big + off) = big;
        *reinterpret_cast<float4*>(q_small + off) = small;
      }
    }
    mbar_wait(bar, it & 1);
    for (int e = tid; e < BN * D4; e += NT) {  // K: [key][d]
      const int r = e / D4, c4 = e % D4;
      float4 big, small;
      split4(reinterpret_cast<const float4*>(k_raw)[e], big, small);
      const int off = wg_swz(r, c4, BN);
      *reinterpret_cast<float4*>(k_big + off) = big;
      *reinterpret_cast<float4*>(k_small + off) = small;
    }
    for (int e = tid; e < D * (BN / 4); e += NT) {  // V^T: [d][logical key]
      const int d = e % D, j = e / D;  // logical keys 4j..4j+3: physical 8(j/2) + (j&1) + 0,2,4,6
      const float* src = v_raw + (8 * (j >> 1) + (j & 1)) * D + d;
      float4 big, small;
      split4(make_float4(src[0], src[2 * D], src[4 * D], src[6 * D]), big, small);
      const int off = d * 128 + ((j ^ (d & 7)) << 4);
      *reinterpret_cast<float4*>(v_big + off) = big;
      *reinterpret_cast<float4*>(v_small + off) = small;
    }
    fence_proxy_async();  // the parts, written by threads, visible to wgmma
    __syncthreads();      // ... and complete; the raw stage is free
    if (tid == 0 && it + 1 < items) issue(it + 1);
    if (start && c == 0) {  // (row g, k t), (g+8, t), (g, t+4), (g+8, t+4) of each k-step
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int r = (f & 1) ? rl1 : rl0, k = 8 * ks + t + 4 * (f >> 1);
          qreg[ks][f] = *reinterpret_cast<const uint32_t*>(q_big + wg_swz(r, k >> 2, BQ) +
                                                           4 * (k & 3));
        }
    }

    // S = Q K^T: D/8 steps of small.big, big.small, big.big.
    float sc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[i] = 0.f;  // overwritten: the first wgmma has scale_d = 0
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      const int qo = (ks >> 2) * BQ * 128 + wg * 64 * 128 + (ks & 3) * 32;
      const int ko = (ks >> 2) * BN * 128 + (ks & 3) * 32;
      Wgmma<32>::ss(sc, wg_desc(q_small + qo), wg_desc(k_big + ko), ks > 0);
      Wgmma<32>::rs(sc, qreg[ks], wg_desc(k_small + ko), 1);
      Wgmma<32>::rs(sc, qreg[ks], wg_desc(k_big + ko), 1);
    }
    wg_commit();
    wg_wait0();

    // Bias and masks on the accumulators, then the online softmax: sc[4i + e]
    // is row rl0 (e < 2) or rl1, key 8i + 2t + (e & 1) of the chunk, the
    // mma.sync kernels' fragment layout.
    float alpha[2];
    flash_softmax<4>(reinterpret_cast<float(*)[4]>(sc), 1.f, a, sl, BQ, qt, kt, rl0, c * BN, t,
                     mrow, lrow, alpha);
    if (flash_moved(alpha))
#pragma unroll
      for (int e = 0; e < NO; ++e) o[e] *= alpha[(e >> 1) & 1];

    // P as the A fragment of each 8-key step i, split: (row g, logical t)
    // = key 2t, (g+8, t) = key 2t, (g, t+4) = key 2t+1, (g+8, t+4) = key 2t+1.
    uint32_t pbig[4][4], psmall[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      tf32_split(sc[4 * i + 0], pbig[i][0], psmall[i][0]);
      tf32_split(sc[4 * i + 2], pbig[i][1], psmall[i][1]);
      tf32_split(sc[4 * i + 1], pbig[i][2], psmall[i][2]);
      tf32_split(sc[4 * i + 3], pbig[i][3], psmall[i][3]);
    }

    // O += P V: four 8-key steps of small.big, big.small, big.big.
    wg_fence();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      Wgmma<D>::rs(o, psmall[i], wg_desc(v_big + 32 * i), 1);
      Wgmma<D>::rs(o, pbig[i], wg_desc(v_small + 32 * i), 1);
      Wgmma<D>::rs(o, pbig[i], wg_desc(v_big + 32 * i), 1);
    }
    wg_commit();
    wg_wait0();

    if (last && c == NCH - 1) {  // o[4n + e]: row rl0 (e < 2) or rl1, column 8n + 2t + (e & 1)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float l = lrow[h];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float li = l == 0.f ? 1.f : l;
        float* orow = ob + (long long)(qt * BQ + (h ? rl1 : rl0)) * D + 2 * t;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<float2*>(orow + 8 * n) =
              make_float2(o[4 * n + 2 * h] / li, o[4 * n + 2 * h + 1] / li);
      }
    }
    __syncthreads();  // every warpgroup is done with the parts before the next split
  }
}

template <int BQ, int D>
static int flash_wgmma_t(const FlashArgs& a, long long blocks, cudaStream_t st) {
  using T = WgTile<BQ, D>;
  const size_t smem = T::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_wgmma_kernel<BQ, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_wgmma_kernel<BQ, D><<<(unsigned)blocks, T::NT, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int BQ>
static int flash_wgmma_d(const FlashArgs& a, int d, long long blocks, cudaStream_t st) {
  switch (d) {
    case 16: return flash_wgmma_t<BQ, 16>(a, blocks, st);
    case 32: return flash_wgmma_t<BQ, 32>(a, blocks, st);
    case 64: return flash_wgmma_t<BQ, 64>(a, blocks, st);
    case 128: return flash_wgmma_t<BQ, 128>(a, blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// float32 q, k, v, o; block_q 64 or 128.  q, k and v must be 16-byte
// aligned (the bulk copies and float4 loads).
extern "C" int flash_wgmma_launch(void* o, const void* q, const void* k, const void* v,
                                  const void* bias, int bias_b, int bias_h, const void* seg,
                                  int b, int hq, int hkv, int s, int d, int block_q,
                                  int folded, float scale, void* stream) {
  FlashArgs a;
  long long blocks;
  if (!flash_args(&a, o, q, k, v, bias, bias_b, bias_h, seg, b, hq, hkv, s, block_q, folded,
                  scale, &blocks))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (block_q) {
    case 64: return flash_wgmma_d<64>(a, d, blocks, st);
    case 128: return flash_wgmma_d<128>(a, d, blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

