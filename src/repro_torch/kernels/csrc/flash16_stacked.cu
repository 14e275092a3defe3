// Causal flash attention forward, bfloat16 and float16, at 8-, 16- and
// 32-row tiles on Hopper's warpgroup MMA, with the query tiles of a GQA
// group's heads stacked in a warpgroup's 64 rows.  Float32 online
// softmax, GQA without a repeated K/V tensor, optional additive float32
// bias and segment ids; the walk of the 2-simplex of (q tile, kv tile)
// pairs is flash_common.cuh's.
//
// Replaces: the TPU kernel of repro/kernels/flash_attention.py
// _flash_launch (kernel table row 5c) for bfloat16 and float16 at
// block_q in {8, 16, 32}; flash16_wgmma.cu serves 64 and 128.
//
// Bound on the card: the products QK^T and PV, 4 * D operations a
// visible (query, key) pair, on the 16-bit tensor cores (989 TFLOP/s):
// operations at every shape here (0.143 ms at B 4, Hq 32, S 2080,
// D 128).  The arithmetic issues three products, not two (P in two
// parts).
//
// Numerics: flash16_wgmma.cu's (wgmma16.cuh), the reference's float32
// arithmetic on 16-bit inputs: S = Q K^T exact in float32, the scale
// after the product, the online softmax in float32 (log2 domain), O +=
// lo V + hi V with P as two parts of the input type, one rounding at the
// end.
//
// Why stacked: a warpgroup's product is 64 rows tall, so one head's 8-32
// query rows cannot fill it; and a block per (query head, pair) makes
// each head of a GQA group stream the same K/V head's tiles again.  Here:
// - Rows: a warpgroup's 64 rows hold the same q tile of SLOTS = 64 / BQ
//   query heads, row r tile row r % BQ of head slot r / BQ (stack_slot,
//   stack_tile_row); NWG warpgroups a block take HB = NWG * SLOTS heads.
//   All of them read one K/V head and stand at the same step of the walk,
//   so the causal mask and the segment ids (per batch: the heads of a
//   group lie in one batch) are the same for every slot, and the bias
//   slab is chosen per row by its head (bias_h may be 1 or Hq).
// - Padding: where the group has fewer heads than the block's slots
//   (Hq == Hkv, a small group), the slots past it are zero Q rows with
//   no bias, and are never stored; every (head, tile) is computed once.
// - Grid: block = ((b * Hkv + kvh) * head groups + head group) * pairs +
//   pair row, head groups = ceil(group / HB) (stack_head_groups, shared
//   by the host and the kernel).
// - Keys: the walk of pair row p visits q tile p's kv tiles 0..p, then
//   (folded) q tile nq-1-p's: each q tile qt reads keys [0, (qt + 1) BQ).
//   Those kv steps are merged into 64-key chunks (F16_BN keys: two steps
//   at BQ 32, four at 16, eight at 8), so S is m64n64k16 and PV k16 as in
//   flash16_wgmma.cu; the chunk that reaches past the tile is cut by the
//   causal mask (key <= query), and a key row past S lands as zeros.
//   Every chunk wholly below the tile's first row is dense (no mask).
// - Copies: every K/V chunk is copied once a block, for all its heads,
//   into the 128-byte swizzle through flash16_wgmma.cu's cp.async ring;
//   Q once per q tile for all stacked heads.  The pipeline (S of chunk i
//   beside PV of chunk i-1, the softmax under PV) is flash16_wgmma.cu's.
// - Shared memory at D 128: one warpgroup 113 KB (two blocks an SM), two
//   warpgroups 129 KB (one).  kernels/flash_attention.py
//   flash16_warpgroups picks NWG by a fixed rule.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "wgmma16.cuh"

// kernels/flash_attention.py flash_smem_bytes mirrors SMEM_BYTES.
template <int BQ, int NWG, int D>
struct StackTile {
  static constexpr int SLOTS = 64 / BQ;               // heads a warpgroup
  static constexpr int HB = NWG * SLOTS;              // heads a block
  static constexpr int QR = NWG * 64;                 // rows of the Q stack
  static constexpr int NT = NWG * 128;                // threads
  static constexpr int DA = (D + 63) / 64;            // 128-byte atoms along D
  static constexpr int NV = DA * 64;                  // columns of the PV product
  static constexpr int Q_BYTES = DA * QR * 128;       // the Q stack
  static constexpr int KV_BYTES = DA * F16_BN * 128;  // one K (or V) chunk
  static constexpr int SMEM_BYTES = 1024 + Q_BYTES + 2 * F16_STAGES * KV_BYTES;
};

// Head groups of a KV head: blocks along the group (host and kernel).
static __host__ __device__ __forceinline__ int stack_head_groups(int group, int hb) {
  return (group + hb - 1) / hb;
}
// Row r of the Q stack: its head slot and its row of the q tile.
static __device__ __forceinline__ int stack_slot(int r, int bq) { return r / bq; }
static __device__ __forceinline__ int stack_tile_row(int r, int bq) { return r % bq; }
// 64-key chunks of q tile qt: keys [0, (qt + 1) bq).
static __device__ __forceinline__ int stack_chunks(int qt, int bq) {
  return ((qt + 1) * bq + F16_BN - 1) / F16_BN;
}

// One 64-key chunk's scores through the scale, the masks and the bias
// into the log2 domain for online16: sc[4i + e] is the lane's row h =
// (i >> 1) & 1 at query position qpos[h], key cbase + 8i + 2t + (e & 1);
// visible where key <= qpos[h] and (segment ids) in the same segment;
// brow[h] is that row's bias row, or null.  Returns the visible bits.
static __device__ __forceinline__ unsigned stack_mask(float* sc, float scale, bool dense,
                                                      const int* seg, const float* const* brow,
                                                      const int* qpos, int cbase, int t) {
  constexpr float LOG2E = 1.4426950408889634f;
  constexpr int N = F16_BN / 2;  // scores a thread
  if (dense) {
    const float sl2 = scale * LOG2E;
#pragma unroll
    for (int i = 0; i < N; ++i) sc[i] *= sl2;
    return ~0u;
  }
  unsigned valid = 0u;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int h = (i >> 1) & 1;
    const int key = cbase + 8 * (i >> 2) + 2 * t + (i & 1);
    bool ok = key <= qpos[h];
    if (ok && seg) ok = seg[qpos[h]] == seg[key];
    float x = sc[i] * scale;
    if (ok && brow[h]) x += brow[h][key];
    sc[i] = ok ? x * LOG2E : FLASH_NEG_INF;
    if (ok) valid |= 1u << i;
  }
  return valid;
}

// O / l of the lane's two rows, rounded once to T: o[4n + e] is row rl0
// (e < 2) or rl0 + 8, column 8n + 2t + (e & 1).  orow(h) gives column 2t
// of row h's output, or null for a row that is not stored; it is asked
// only after the row's sum, so no row pointer lives across the shuffles.
// (flash16_wgmma.cu keeps its own store with no null test: this one cost
// it 1-3 % at the serve shape.)
template <typename T, int D, typename RowPtr>
static __device__ __forceinline__ void store16(const float* o, const float* lrow,
                                               RowPtr orow) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = lrow[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float li = l == 0.f ? 1.f : l;
    T* dst = orow(h);
    if (dst)
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(dst + 8 * n) =
            Flash16Parts<T>::pack(o[4 * n + 2 * h] / li, o[4 * n + 2 * h + 1] / li);
  }
}

template <int BQ, int NWG, int D, typename T>
__global__ void __launch_bounds__(StackTile<BQ, NWG, D>::NT, 1)
flash16_stacked_kernel(FlashArgs a) {
  using St = StackTile<BQ, NWG, D>;
  using W = Wg16<T>;
  constexpr int NT = St::NT, QR = St::QR, BN = F16_BN, NV = St::NV;
  constexpr int D8 = D / 8;              // 16-byte pieces a row
  constexpr int AHEAD = F16_STAGES - 2;  // chunks in flight beyond the one computed
  constexpr int QLOADS = (QR * D8 + NT - 1) / NT;
  extern __shared__ __align__(16) unsigned char smem16s[];
  // Every operand on a 1024-byte boundary: the swizzle atoms must be.
  unsigned char* q_s = smem16s + ((1024 - (smem_addr(smem16s) & 1023)) & 1023);
  unsigned char* k_s = q_s + St::Q_BYTES;                // [F16_STAGES] K chunks
  unsigned char* v_s = k_s + F16_STAGES * St::KV_BYTES;  // [F16_STAGES] V chunks

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;  // warpgroup; warp within it
  const int g = lane >> 2, t = lane & 3;
  const int s = a.s, hkv = a.hq / a.group;
  // The block: pair row p of head group hg of KV row kvrow = b * Hkv + kvh.
  const int pairs = a.folded ? (a.nq + 1) / 2 : a.nq;
  const int hgs = stack_head_groups(a.group, St::HB);
  const int p = (int)(blockIdx.x % pairs);
  const int hg = (int)(blockIdx.x / pairs % hgs);
  const long long kvrow = blockIdx.x / pairs / hgs;
  const long long batch = kvrow / hkv;
  const int head0 = (int)(kvrow % hkv) * a.group + hg * St::HB;  // slot 0's head, of Hq
  const int live = min(St::HB, a.group - hg * St::HB);          // slots that hold a head
  const T* qb = (const T*)a.q + (batch * a.hq + head0) * s * D;  // slot j at + j * s * D
  const T* kb = (const T*)a.k + kvrow * s * D;
  const T* vb = (const T*)a.v + kvrow * s * D;
  T* ob = (T*)a.o + (batch * a.hq + head0) * s * D;
  const int* seg = a.seg ? a.seg + batch * s : nullptr;

  // The walk's q tiles: p (kv tiles 0..p), then, folded, nq-1-p.
  int qt0, qt1, kt;
  bool st, la;
  flash_step(a, p, 0, qt0, kt, st, la);
  flash_step(a, p, a.folded ? a.nq : 0, qt1, kt, st, la);
  const int n0 = stack_chunks(qt0, BQ);
  const int items = n0 + (a.folded ? stack_chunks(qt1, BQ) : 0);  // (q tile, chunk) in order

  // Every thread: its 16-byte pieces of chunk it's K and V into stage
  // it % F16_STAGES (keys past S zero-filled), then one commit (an empty
  // group past the last chunk keeps the count of groups in flight).
  auto issue = [&](int it) {
    if (it < items) {
      const int k0 = (it < n0 ? it : it - n0) * BN;
      unsigned char* kd = k_s + (it % F16_STAGES) * St::KV_BYTES;
      unsigned char* vd = v_s + (it % F16_STAGES) * St::KV_BYTES;
#pragma unroll
      for (int i = 0; i < (BN * D8 + NT - 1) / NT; ++i) {
        const int e = tid + i * NT, r = e / D8, c = e % D8;
        if (e < BN * D8) {
          const int off = f16_swz(r, c, BN);
          const bool in = k0 + r < s;
          const long long src = in ? (long long)(k0 + r) * D + 8 * c : 0;
          cp_async16_zfill(kd + off, kb + src, in ? 16 : 0);
          cp_async16_zfill(vd + off, vb + src, in ? 16 : 0);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < AHEAD; ++i) issue(i);

  // The lane's rows of the stack: wg * 64 + wq * 16 + g and 8 below it.
  const int rl0 = wg * 64 + wq * 16 + g;
  const long long sb = a.bias_b > 1 ? batch % a.bias_b : 0;  // the bias slab's batch
  int qpos[2];
  const float* brow[2] = {nullptr, nullptr};
  float o[NV / 2], mrow[2], lrow[2];
  uint32_t hi[BN / 16][4], lo[BN / 16][4];
  bool has_p = false;
  for (int it = 0; it < items; ++it) {
    const bool first = it < n0;
    const int qt = first ? qt0 : qt1;
    const int c = first ? it : it - n0;
    const int nch = first ? n0 : items - n0;
    // Chunk it lands (chunks it+1.. may stay in flight); after the barrier
    // every warpgroup is done with the chunks before it-1 (their PV was
    // waited for) and with Q's reads.
    cp_async_wait<AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();
    issue(it + AHEAD);  // into the stage chunk it-2 used
    if (c == 0) {  // a new query tile: the stack of Q, once
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // the row's query position and bias row (by its head)
        const int r = rl0 + 8 * h;
        mrow[h] = FLASH_NEG_INF;
        lrow[h] = 0.f;
        qpos[h] = qt * BQ + stack_tile_row(r, BQ);
        brow[h] = nullptr;
        if (a.bias && stack_slot(r, BQ) < live) {
          const long long sh = a.bias_h > 1 ? (head0 + stack_slot(r, BQ)) % a.bias_h : 0;
          brow[h] = a.bias + ((sb * a.bias_h + sh) * s + qpos[h]) * (long long)s;
        }
      }
#pragma unroll
      for (int e = 0; e < NV / 2; ++e) o[e] = 0.f;
      uint4 qv[QLOADS];
#pragma unroll
      for (int i = 0; i < QLOADS; ++i) {
        const int e = tid + i * NT, r = e / D8;
        const int sr = stack_slot(r, BQ);
        qv[i] = make_uint4(0u, 0u, 0u, 0u);  // padding slots stay zero
        if (e < QR * D8 && sr < live)
          qv[i] = __ldg(reinterpret_cast<const uint4*>(
              qb + (long long)sr * s * D + (long long)(qt * BQ + stack_tile_row(r, BQ)) * D +
              8 * (e % D8)));
      }
#pragma unroll
      for (int i = 0; i < QLOADS; ++i) {
        const int e = tid + i * NT;
        if (e < QR * D8) *reinterpret_cast<uint4*>(q_s + f16_swz(e / D8, e % D8, QR)) = qv[i];
      }
      fence_proxy_async();
      __syncthreads();
    }
    const unsigned char* kc = k_s + (it % F16_STAGES) * St::KV_BYTES;

    // S = Q K^T, then, as its own group, O += lo V + hi V of chunk it-1.
    float sc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;  // overwritten: the first wgmma has scale_d = 0
    qk16<W, D, QR>(sc, q_s, kc, wg);
    if (has_p) {
      pv<W, NV>(o, hi, lo, v_s + ((it - 1) % F16_STAGES) * St::KV_BYTES);
      wg_wait<1>();  // S is done; PV may still run
    } else {
      wg_wait<0>();
    }
    wg_pin(sc);

    // Scale, bias and masks on the accumulators, then the online softmax.
    const bool dense = !seg && !a.bias && (c + 1) * BN - 1 <= qt * BQ;
    float alpha[2];
    online16(sc, stack_mask(sc, a.scale, dense, seg, brow, qpos, c * BN, t), mrow, lrow, alpha);
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

    if (c == nch - 1) {  // the tile's last chunk: its PV, then O / l of the heads' rows
      wg_fence();
      pv<W, NV>(o, hi, lo, v_s + (it % F16_STAGES) * St::KV_BYTES);
      wg_wait<0>();
      wg_pin(o);
      wg_pin(hi);
      wg_pin(lo);
      has_p = false;
      store16<T, D>(o, lrow, [&](int h) -> T* {  // a padding slot is never stored
        const int sr = stack_slot(rl0 + 8 * h, BQ);
        return sr < live ? ob + (long long)sr * s * D + (long long)qpos[h] * D + 2 * t : nullptr;
      });
    }
  }
}

template <int BQ, int NWG, int D, typename T>
static int flash16_stacked_t(const FlashArgs& a, long long blocks, cudaStream_t st) {
  using St = StackTile<BQ, NWG, D>;
  const size_t smem = St::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash16_stacked_kernel<BQ, NWG, D, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash16_stacked_kernel<BQ, NWG, D, T><<<(unsigned)blocks, St::NT, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int BQ, int NWG, typename T>
static int flash16_stacked_d(const FlashArgs& a, int d, long long blocks, cudaStream_t st) {
  switch (d) {
    case 16: return flash16_stacked_t<BQ, NWG, 16, T>(a, blocks, st);
    case 32: return flash16_stacked_t<BQ, NWG, 32, T>(a, blocks, st);
    case 64: return flash16_stacked_t<BQ, NWG, 64, T>(a, blocks, st);
    case 128: return flash16_stacked_t<BQ, NWG, 128, T>(a, blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int BQ, typename T>
static int flash16_stacked_w(const FlashArgs& a, int nwg, int d, long long blocks,
                             cudaStream_t st) {
  return nwg == 1 ? flash16_stacked_d<BQ, 1, T>(a, d, blocks, st)
                  : flash16_stacked_d<BQ, 2, T>(a, d, blocks, st);
}

template <typename T>
static int flash16_stacked_b(const FlashArgs& a, int block_q, int nwg, int d, long long blocks,
                             cudaStream_t st) {
  switch (block_q) {
    case 8: return flash16_stacked_w<8, T>(a, nwg, d, blocks, st);
    case 16: return flash16_stacked_w<16, T>(a, nwg, d, blocks, st);
    case 32: return flash16_stacked_w<32, T>(a, nwg, d, blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// bfloat16 (dtype 1) or float16 (dtype 2) q, k, v, o; block_q 8, 16 or
// 32; warpgroups 1 or 2 a block.  q, k and v must be 16-byte aligned
// (the 16-byte copies).
extern "C" int flash16_stacked_launch(void* o, const void* q, const void* k, const void* v,
                                      const void* bias, int bias_b, int bias_h, const void* seg,
                                      int b, int hq, int hkv, int s, int d, int block_q,
                                      int folded, float scale, int dtype, int warpgroups,
                                      void* stream) {
  FlashArgs a;
  long long slabs;
  if (!flash_args(&a, o, q, k, v, bias, bias_b, bias_h, seg, b, hq, hkv, s, block_q, folded,
                  scale, &slabs))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15) return (int)cudaErrorInvalidValue;
  if (block_q > 64 || 64 % block_q || (warpgroups != 1 && warpgroups != 2))
    return (int)cudaErrorInvalidValue;
  const long long pairs = folded ? (a.nq + 1) / 2 : a.nq;
  const long long blocks =
      (long long)b * hkv * stack_head_groups(a.group, warpgroups * (64 / block_q)) * pairs;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 1: return flash16_stacked_b<__nv_bfloat16>(a, block_q, warpgroups, d, blocks, st);
    case 2: return flash16_stacked_b<__half>(a, block_q, warpgroups, d, blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
