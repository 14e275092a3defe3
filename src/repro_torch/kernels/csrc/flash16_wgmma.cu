// Causal flash attention forward, bfloat16 and float16, on Hopper's
// warpgroup MMA: 64- and 128-row tiles.  Float32 online softmax, GQA
// without a repeated K/V tensor, optional additive float32 bias and
// segment ids; the walk of the 2-simplex of (q tile, kv tile) pairs is
// flash_common.cuh's.
//
// Replaces: the TPU kernel of repro/kernels/flash_attention.py
// _flash_launch (kernel table row 5b) for bfloat16 and float16 at
// block_q in {64, 128} (flash16_stacked.cu serves the 16-bit types at the
// smaller tiles, flash_wgmma.cu float32 at these).
//
// Bound on the card: the products QK^T and PV, 4 * BQ * BQ * D operations
// a tile pair against 2 * BQ * D * 2 bytes of K and V, BQ operations a
// byte; on the 16-bit tensor cores (989 TFLOP/s, about 295 operations a
// byte) that is operations at every tile here.  At the serve shape (B 4,
// Hq 32, S 2048, D 128) the bound is 0.139 ms.  The arithmetic below
// issues three products, not two (P in two parts), so it cannot go below
// about 0.209 ms at that rate.
//
// Numerics, the reference's float32 arithmetic on 16-bit inputs:
// - S = Q K^T is one wgmma in the input type with float32 accumulators:
//   the product of two bf16 or f16 values is exact in float32.  The scale
//   multiplies the float32 scores after the product, in mask16.
// - P stays float32-accurate as two parts of the input type, hi = round(P)
//   and lo = round(P - hi): O += lo V + hi V, two wgmmas a 16-key step.
//
// Design (BQ / 64 consumer warpgroups, 128 or 256 threads; what held the
// mma.sync kernel back was 16-key sub-chunks, a block barrier and a
// cp.async wait each, 32-bit fragment loads and small MMAs that never
// overlapped the loads or the softmax):
// - Layout: Q, K and V in shared memory as they are, in wgmma's 128-byte
//   swizzle (wgmma16.cuh, which this kernel shares with
//   flash16_stacked.cu); V is the MN-major B operand of PV through the
//   transpose-B immediate: no transposing copy.
// - Copies: 64-key chunks of K and V through a ring of F16_STAGES stages,
//   every thread issuing 16-byte cp.async straight to the swizzled
//   addresses; a chunk is in flight for the whole of the chunk before it.
//   After a thread's copies land it fences them to the async proxy, and
//   one block barrier a chunk publishes them and frees the stage of the
//   chunk two back, which the next copy refills.  Q is loaded once per
//   query tile (unrolled 16-byte loads, a second barrier).
// - S = Q K^T: per warpgroup, D/16 m64n64k16 wgmmas with both operands
//   from shared memory (descriptors: SBO 1024, the 8-row groups).
// - Softmax on the accumulators (mask16, then online16): masks, bias, segment ids,
//   row max and sum in float32, in the log2 domain so that a probability
//   is one FFMA and one ex2; O rescaled only when a row max moved.
// - O += P V: the f32 accumulator of n-tiles 2j and 2j+1 (row g and g+8,
//   columns 2t, 2t+1) is the A register fragment of k-step j as it
//   stands, so P goes to the RS wgmma with no shuffle.  Each 16-key step
//   issues m64nNk16 twice (lo, then hi), N = max(D, 64): B = V read
//   MN-major with LBO the stride of the 64-column atoms and SBO 1024.
//   Below D = 64 the columns past D are never stored.
// - Pipeline, per warpgroup: S of chunk i and PV of chunk i-1 are issued
//   together as two wgmma groups; the softmax of chunk i runs once S is
//   done, while PV of i-1 is still on the tensor cores, and only then is
//   O rescaled and P of chunk i split.  The tile's last chunk issues its
//   own PV.
// - Shared memory at <128, 128>: Q 32 KB, three stages of K and V 96 KB,
//   1 KB alignment slack: 129 KB, one block an SM.
//
// Unchanged semantics: online softmax in float32; masked probabilities
// zeroed, so a row with no visible key keeps l = 0 and gives 0, never
// NaN; the output rounded once to q's type; 64-bit element offsets.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "wgmma16.cuh"

// kernels/flash_attention.py flash_smem_bytes mirrors SMEM_BYTES.
template <int BQ, int D>
struct Wg16Tile {
  static constexpr int NWG = BQ / 64;                 // consumer warpgroups
  static constexpr int NT = NWG * 128;                // threads
  static constexpr int NCH = BQ / F16_BN;             // chunks a KV tile
  static constexpr int DA = (D + 63) / 64;            // 128-byte atoms along D
  static constexpr int NV = DA * 64;                  // columns of the PV product
  static constexpr int Q_BYTES = DA * BQ * 128;       // the Q tile
  static constexpr int KV_BYTES = DA * F16_BN * 128;  // one K (or V) chunk
  static constexpr int SMEM_BYTES = 1024 + Q_BYTES + 2 * F16_STAGES * KV_BYTES;
};

// One 64-key chunk's scores through the scale, the masks and the bias
// into the log2 domain (wgmma16.cuh's online16 takes them from there):
// x = (s * scale + bias) * log2(e).  sc[4i + e] is row rl0 (e < 2) or
// rl0 + 8, key cbase + 8i + 2t + (e & 1).  The causal and segment masks
// and the bias apply off the dense case as in flash_softmax.  Returns the
// visible scores' bits.
static __device__ __forceinline__ unsigned mask16(float* sc, const FlashArgs& a,
                                                  const FlashSlab& sl, int block, int qt,
                                                  int kt, int rl0, int cbase, int t) {
  constexpr float LOG2E = 1.4426950408889634f;
  constexpr int N = F16_BN / 2;  // scores a thread
  const int rl1 = rl0 + 8;
  const bool diag = qt == kt;
  if (!diag && !sl.seg && !sl.bias) {
    const float sl2 = a.scale * LOG2E;
#pragma unroll
    for (int i = 0; i < N; ++i) sc[i] *= sl2;
    return ~0u;
  }
  unsigned valid = 0u;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int rl = (i & 2) ? rl1 : rl0;
    const int cl = cbase + 8 * (i >> 2) + 2 * t + (i & 1);
    bool ok = !(diag && cl > rl);
    const int row = qt * block + rl, col = kt * block + cl;
    if (ok && sl.seg) ok = sl.seg[row] == sl.seg[col];
    float x = sc[i] * a.scale;
    if (ok && sl.bias) x += sl.bias[(long long)row * a.s + col];
    sc[i] = ok ? x * LOG2E : FLASH_NEG_INF;
    if (ok) valid |= 1u << i;
  }
  return valid;
}

// --- the kernel -------------------------------------------------------------

template <int BQ, int D, typename T>
__global__ void __launch_bounds__(Wg16Tile<BQ, D>::NT, 1)
flash16_wgmma_kernel(FlashArgs a) {
  using Tl = Wg16Tile<BQ, D>;
  using W = Wg16<T>;
  constexpr int NT = Tl::NT, NCH = Tl::NCH, BN = F16_BN, NV = Tl::NV;
  constexpr int D8 = D / 8;                // 16-byte pieces a row
  constexpr int AHEAD = F16_STAGES - 2;    // chunks in flight beyond the one computed
  constexpr int QLOADS = (BQ * D8 + NT - 1) / NT;
  extern __shared__ __align__(16) unsigned char smem16w[];
  // Every operand on a 1024-byte boundary: the swizzle atoms must be.
  unsigned char* q_s = smem16w + ((1024 - (smem_addr(smem16w) & 1023)) & 1023);
  unsigned char* k_s = q_s + Tl::Q_BYTES;                // [F16_STAGES] K chunks
  unsigned char* v_s = k_s + F16_STAGES * Tl::KV_BYTES;  // [F16_STAGES] V chunks

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;  // warpgroup; warp within it
  const int g = lane >> 2, t = lane & 3;
  const int s = a.s;
  const FlashSlab sl = flash_slab(a);
  const T* qb = (const T*)a.q + sl.bh * s * D;
  const T* kb = (const T*)a.k + sl.kvh * s * D;
  const T* vb = (const T*)a.v + sl.kvh * s * D;
  T* ob = (T*)a.o + sl.bh * s * D;
  const int p = sl.p;
  const int items = sl.steps * NCH;  // (step, chunk) in order

  // Every thread: its 16-byte pieces of chunk it's K and V into stage
  // it % F16_STAGES, then one commit (an empty group past the last chunk
  // keeps the count of groups in flight).
  auto issue = [&](int it) {
    if (it < items) {
      int qt, kt;
      bool st, la;
      flash_step(a, p, it / NCH, qt, kt, st, la);
      const long long k0 = (long long)kt * BQ + (it % NCH) * BN;
      const T* ksrc = kb + k0 * D;
      const T* vsrc = vb + k0 * D;
      unsigned char* kd = k_s + (it % F16_STAGES) * Tl::KV_BYTES;
      unsigned char* vd = v_s + (it % F16_STAGES) * Tl::KV_BYTES;
#pragma unroll
      for (int i = 0; i < (BN * D8 + NT - 1) / NT; ++i) {
        const int e = tid + i * NT, r = e / D8, c = e % D8;
        if (e < BN * D8) {
          const int off = f16_swz(r, c, BN);
          cp_async16(kd + off, ksrc + (long long)r * D + 8 * c);
          cp_async16(vd + off, vsrc + (long long)r * D + 8 * c);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < AHEAD; ++i) issue(i);

  // The pipeline, per warpgroup: S of chunk it and PV of chunk it-1 go to
  // the tensor cores together, and the softmax of chunk it runs while PV
  // of it-1 is in flight.  pc holds P of chunk it-1 (its two parts, the A
  // fragment of each 16-key step) while has_p.
  const int rl0 = wg * 64 + wq * 16 + g, rl1 = rl0 + 8;  // the lane's tile-local rows
  float o[NV / 2], mrow[2], lrow[2];
  uint32_t hi[BN / 16][4], lo[BN / 16][4];
  bool has_p = false;
  for (int it = 0; it < items; ++it) {
    const int c = it % NCH;
    int qt, kt;
    bool start, last;
    flash_step(a, p, it / NCH, qt, kt, start, last);
    // Chunk it lands (chunks it+1.. may stay in flight); after the barrier
    // every warpgroup is done with the chunks before it-1 (their PV was
    // waited for) and with Q's reads.
    cp_async_wait<AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();
    issue(it + AHEAD);  // into the stage chunk it-2 used
    if (start && c == 0) {  // a new query tile: Q, once
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mrow[h] = FLASH_NEG_INF;
        lrow[h] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < NV / 2; ++e) o[e] = 0.f;
      const T* qsrc = qb + (long long)qt * BQ * D;
      uint4 qv[QLOADS];
#pragma unroll
      for (int i = 0; i < QLOADS; ++i) {
        const int e = tid + i * NT;
        if (e < BQ * D8)
          qv[i] = __ldg(reinterpret_cast<const uint4*>(qsrc + (long long)(e / D8) * D +
                                                       8 * (e % D8)));
      }
#pragma unroll
      for (int i = 0; i < QLOADS; ++i) {
        const int e = tid + i * NT;
        if (e < BQ * D8) *reinterpret_cast<uint4*>(q_s + f16_swz(e / D8, e % D8, BQ)) = qv[i];
      }
      fence_proxy_async();
      __syncthreads();
    }
    const unsigned char* kc = k_s + (it % F16_STAGES) * Tl::KV_BYTES;

    // S = Q K^T, then, as its own group, O += lo V + hi V of chunk it-1.
    float sc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;  // overwritten: the first wgmma has scale_d = 0
    qk16<W, D, BQ>(sc, q_s, kc, wg);
    if (has_p) {
      pv<W, NV>(o, hi, lo, v_s + ((it - 1) % F16_STAGES) * Tl::KV_BYTES);
      wg_wait<1>();  // S is done; PV may still run
    } else {
      wg_wait<0>();
    }
    wg_pin(sc);

    // Scale, bias and masks on the accumulators, then the online softmax.
    float alpha[2];
    online16(sc, mask16(sc, a, sl, BQ, qt, kt, rl0, c * BN, t), mrow, lrow, alpha);
    if (has_p) {  // PV of chunk it-1 done: O and P's registers are free
      wg_wait<0>();
      wg_pin(o);
      wg_pin(hi);
      wg_pin(lo);
    }
    if (flash_moved(alpha))
#pragma unroll
      for (int e = 0; e < NV / 2; ++e) o[e] *= alpha[(e >> 1) & 1];

    p_parts<T>(sc, hi, lo);
    has_p = true;

    if (last && c == NCH - 1) {  // the tile's last chunk: its PV, then O / l
      wg_fence();
      pv<W, NV>(o, hi, lo, v_s + (it % F16_STAGES) * Tl::KV_BYTES);
      wg_wait<0>();
      wg_pin(o);
      wg_pin(hi);
      wg_pin(lo);
      has_p = false;
      // o[4n + e]: row rl0 (e < 2) or rl1, column 8n + 2t + (e & 1)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float l = lrow[h];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float li = l == 0.f ? 1.f : l;
        T* orow = ob + (long long)(qt * BQ + (h ? rl1 : rl0)) * D + 2 * t;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<uint32_t*>(orow + 8 * n) =
              Flash16Parts<T>::pack(o[4 * n + 2 * h] / li, o[4 * n + 2 * h + 1] / li);
      }
    }
  }
}

template <int BQ, int D, typename T>
static int flash16_wgmma_t(const FlashArgs& a, long long blocks, cudaStream_t st) {
  using Tl = Wg16Tile<BQ, D>;
  const size_t smem = Tl::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash16_wgmma_kernel<BQ, D, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash16_wgmma_kernel<BQ, D, T><<<(unsigned)blocks, Tl::NT, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int BQ, typename T>
static int flash16_wgmma_d(const FlashArgs& a, int d, long long blocks, cudaStream_t st) {
  switch (d) {
    case 16: return flash16_wgmma_t<BQ, 16, T>(a, blocks, st);
    case 32: return flash16_wgmma_t<BQ, 32, T>(a, blocks, st);
    case 64: return flash16_wgmma_t<BQ, 64, T>(a, blocks, st);
    case 128: return flash16_wgmma_t<BQ, 128, T>(a, blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
static int flash16_wgmma_b(const FlashArgs& a, int block_q, int d, long long blocks,
                           cudaStream_t st) {
  switch (block_q) {
    case 64: return flash16_wgmma_d<64, T>(a, d, blocks, st);
    case 128: return flash16_wgmma_d<128, T>(a, d, blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// bfloat16 (dtype 1) or float16 (dtype 2) q, k, v, o; block_q 64 or 128.
// q, k and v must be 16-byte aligned (the 16-byte copies).
extern "C" int flash16_wgmma_launch(void* o, const void* q, const void* k, const void* v,
                                    const void* bias, int bias_b, int bias_h, const void* seg,
                                    int b, int hq, int hkv, int s, int d, int block_q,
                                    int folded, float scale, int dtype, void* stream) {
  FlashArgs a;
  long long blocks;
  if (!flash_args(&a, o, q, k, v, bias, bias_b, bias_h, seg, b, hq, hkv, s, block_q, folded,
                  scale, &blocks))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 1: return flash16_wgmma_b<__nv_bfloat16>(a, block_q, d, blocks, st);
    case 2: return flash16_wgmma_b<__half>(a, block_q, d, blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
