// Causal flash attention forward on the 2-simplex of (q tile, kv tile)
// pairs on mma.sync: float32 at 8-, 16- and 32-row tiles; float32 online
// softmax, GQA without a repeated K/V tensor, optional additive float32
// bias and segment ids.  The other flash kernels are on wgmma:
// flash_wgmma.cu (float32 at 64- and 128-row tiles), flash16_wgmma.cu
// (bfloat16, float16 at 64 and 128) and flash16_stacked.cu (bfloat16,
// float16 at 8, 16 and 32).
//
// Replaces: the TPU kernel of repro/kernels/flash_attention.py
// _flash_launch (kernel table row 5a), a Pallas grid (B*Hq, pairs, nq+1)
// or (B*Hq, nq, nq) whose sequential last axis carried the running max,
// denominator and accumulator in VMEM scratch from one grid step to the
// next.  The map on the GPU is flash_common.cuh's: blocks run in
// parallel and in no order, so the sequential grid axis becomes a loop
// inside the block over the block's (b*Hq, pair) or (b*Hq, q tile).
//
// FLOAT32 (flash_fwd_kernel).
//
// Bound on the card: the products QK^T and PV, 4*BQ*BQ*D operations a
// tile pair against 2*BQ*D*4 bytes of K and V, BQ/2 operations a byte;
// on the tensor cores at float32 accuracy (3xTF32, 495/3 TFLOP/s, about
// 49 operations a byte) that is operations from BQ = 128 up and bytes
// below it.
//
// Design (FlashAttention-2's layout on mma.sync): each warp owns 16
// query rows of the BQ-row tile (BQ = 8 pads the warp's rows with
// zeros, which are never written).  Each warp stages its own scaled Q
// rows once per query tile, and the block streams the KV tile through
// shared memory in sub-chunks of BC = min(16, BQ) keys, double buffered
// with cp.async (16 bytes a thread, cp.async.cg): the copy of sub-chunk
// i+1 is issued right after the one barrier that makes sub-chunk i
// visible, and runs under i's arithmetic.  Per sub-chunk a warp
// computes S = Q K^T (16 x BC) with 3xTF32 mma.sync (mma_tf32.cuh) into
// accumulator fragments, applies bias, the causal mask and the segment
// mask there, runs the online max over each row's quad with
// __shfl_xor_sync, moves P from the accumulator layout into the A
// layout of the next MMA with shuffles, and accumulates O += P V
// (16 x D in registers) with 3xTF32 again; O is rescaled only when a
// row's max moved (a warp vote).  The MMAs go out product by product
// across output tiles, so no MMA waits on the one before it.  Rows are
// padded to D+4 floats for Q and K and D+8 for V, so every fragment load
// hits 32 distinct banks.  Each lane keeps its own part of a row's
// denominator; the quad sums it at the flush.  The 3xTF32 splits cost
// about as many instructions as the MMAs, so the kernel is latency and
// issue bound: 16-key sub-chunks and at most 128 registers a thread let
// two blocks share an SM.  It serves the tiles below 64 rows, where a
// warpgroup's 64-row tile (flash_wgmma.cu) does not fit.
//
// Masked probabilities are zeroed, so a row with no visible key so far
// keeps l = 0 and its output becomes 0, never NaN.  The products carry
// float32 accuracy (each drops only small_q.small_k, below 2^-22 of the
// term), and the softmax over sub-chunks of a tile is the same online
// recurrence as over whole tiles, so the result differs from the plain
// version by float32 rounding only.  Element offsets are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "mma_tf32.cuh"

// kernels/flash_attention.py flash_smem_bytes mirrors SMEM_FLOATS.
template <int BQ, int D>
struct FlashTile {
  static constexpr int WARPS = BQ < 16 ? 1 : BQ / 16;  // 16 query rows each
  static constexpr int NT = WARPS * 32;                // threads per block
  static constexpr int QR = WARPS * 16;                // staged Q rows
  static constexpr int BC = BQ < 16 ? BQ : 16;         // keys per sub-chunk
  static constexpr int NCH = BQ / BC;                  // sub-chunks per KV tile
  static constexpr int QLD = D + 4;                    // Q, K rows: A / B fragments
  static constexpr int KLD = D + 4;                    //   read banks 4g + t
  static constexpr int VLD = D + 8;                    // V rows: banks 8t + g
  static constexpr int SMEM_FLOATS = QR * QLD + 2 * BC * KLD + 2 * BC * VLD;
};

template <int BQ, int D>
__global__ void __launch_bounds__(FlashTile<BQ, D>::NT, 2)
flash_fwd_kernel(FlashArgs a) {
  using T = FlashTile<BQ, D>;
  constexpr int BC = T::BC, NCH = T::NCH, NT = T::NT;
  constexpr int QLD = T::QLD, KLD = T::KLD, VLD = T::VLD;
  constexpr int NKT = BC / 8;  // 8-key pieces: n-tiles of S, k-steps of PV
  constexpr int NDT = D / 8;   // 8-column pieces: k-steps of QK^T, n-tiles of O
  constexpr int GD = 2;        // O tiles per group of PV MMAs (0 spills at D = 128)
  constexpr int V4 = D / 4;    // float4s a row
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                // [QR][QLD]     scaled Q
  float* k_s = q_s + T::QR * QLD;   // [2][BC][KLD]  K sub-chunks
  float* v_s = k_s + 2 * BC * KLD;  // [2][BC][VLD]  V sub-chunks

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int s = a.s;
  const FlashSlab sl = flash_slab(a);
  const float* qb = (const float*)a.q + sl.bh * s * D;
  const float* kb = (const float*)a.k + sl.kvh * s * D;
  const float* vb = (const float*)a.v + sl.kvh * s * D;
  float* ob = (float*)a.o + sl.bh * s * D;
  const int p = sl.p;
  const int items = sl.steps * NCH;  // (step, sub-chunk) in order

  // Issue the cp.async copies of item it's K and V into buffer it & 1.
  auto load_kv = [&](int it) {
    int qt, kt;
    bool st, la;
    flash_step(a, p, it / NCH, qt, kt, st, la);
    const long long k0 = (long long)kt * BQ + (it % NCH) * BC;
    const float* ks = kb + k0 * D;
    const float* vs = vb + k0 * D;
    float* kd = k_s + (it & 1) * BC * KLD;
    float* vd = v_s + (it & 1) * BC * VLD;
    for (int e = tid; e < BC * V4; e += NT) {
      const int r = e / V4, c4 = 4 * (e % V4);
      cp_async16(kd + r * KLD + c4, ks + r * D + c4);
      cp_async16(vd + r * VLD + c4, vs + r * D + c4);
    }
    cp_async_commit();
  };

  const int rl0 = warp * 16 + g, rl1 = rl0 + 8;  // the lane's tile-local rows
  float o[NDT][4], mrow[2], lrow[2];
  const float* qw = q_s + warp * 16 * QLD;
  load_kv(0);
  for (int it = 0; it < items; ++it) {
    const int c = it % NCH;
    int qt, kt;
    bool start, last;
    flash_step(a, p, it / NCH, qt, kt, start, last);
    cp_async_wait_all();
    __syncthreads();  // item it's K, V visible; every warp is done with item it-1
    if (it + 1 < items) load_kv(it + 1);  // into item it-1's buffer, under this compute
    if (start && c == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mrow[h] = FLASH_NEG_INF;
        lrow[h] = 0.f;
      }
#pragma unroll
      for (int dt = 0; dt < NDT; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
      __syncwarp();  // the warp's reads of the previous Q tile are done
      const float* qsrc = qb + (long long)qt * BQ * D;
      for (int e = lane; e < 16 * V4; e += 32) {
        const int r = e / V4, c4 = 4 * (e % V4), row = warp * 16 + r;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row < BQ) {
          x = __ldg(reinterpret_cast<const float4*>(qsrc + (long long)row * D + c4));
          x.x *= a.scale;
          x.y *= a.scale;
          x.z *= a.scale;
          x.w *= a.scale;
        }
        *reinterpret_cast<float4*>(q_s + row * QLD + c4) = x;
      }
      __syncwarp();
    }
    const float* kc = k_s + (it & 1) * BC * KLD;
    const float* vc = v_s + (it & 1) * BC * VLD;

    // S = Q K^T on the tensor cores.
    float sc[NKT][4];
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll 1
    for (int kd = 0; kd < NDT; ++kd) {
      const float* q0 = qw + g * QLD + kd * 8 + t;
      FragA fa;
      frag_a(fa, q0[0], q0[8 * QLD], q0[4], q0[8 * QLD + 4]);
      FragB fb[NKT];
#pragma unroll
      for (int nt = 0; nt < NKT; ++nt) {
        const float* k0 = kc + (nt * 8 + g) * KLD + kd * 8 + t;
        frag_b(fb[nt], k0[0], k0[4]);
      }
      mma3<NKT>(sc, fa, fb);
    }

    // Bias and masks on the fragments, then the online softmax.
    float alpha[2];
    flash_softmax<NKT>(sc, 1.f, a, sl, BQ, qt, kt, rl0, c * BC, t, mrow, lrow, alpha);
    if (flash_moved(alpha))
#pragma unroll
      for (int dt = 0; dt < NDT; ++dt) {
        o[dt][0] *= alpha[0];
        o[dt][1] *= alpha[0];
        o[dt][2] *= alpha[1];
        o[dt][3] *= alpha[1];
      }

    // O += P V: P[g][t] sits in lane 4g + t/2 (element t & 1), P[g][t+4]
    // in lane 4g + 2 + t/2.
    const int src0 = 4 * g + (t >> 1), src1 = src0 + 2;
    const bool odd = t & 1;
#pragma unroll
    for (int kk = 0; kk < NKT; ++kk) {
      float x[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[e] = __shfl_sync(0xffffffffu, sc[kk][e], src0);
        x[4 + e] = __shfl_sync(0xffffffffu, sc[kk][e], src1);
      }
      FragA pa;
      frag_a(pa, odd ? x[1] : x[0], odd ? x[3] : x[2], odd ? x[5] : x[4], odd ? x[7] : x[6]);
#pragma unroll
      for (int d0 = 0; d0 < NDT; d0 += GD) {
        FragB fb[GD];
#pragma unroll
        for (int j = 0; j < GD; ++j) {
          const float* v0 = vc + (kk * 8 + t) * VLD + (d0 + j) * 8 + g;
          frag_b(fb[j], v0[0], v0[4 * VLD]);
        }
        mma3<GD>(o + d0, pa, fb);
      }
    }

    if (last && c == NCH - 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float l = lrow[h];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float li = l == 0.f ? 1.f : l;
        const int rl = h ? rl1 : rl0;
        if (rl < BQ) {
          float* orow = ob + (long long)(qt * BQ + rl) * D + 2 * t;
#pragma unroll
          for (int dt = 0; dt < NDT; ++dt)
            *reinterpret_cast<float2*>(orow + dt * 8) =
                make_float2(o[dt][2 * h] / li, o[dt][2 * h + 1] / li);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename K>
static int flash_set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <int BQ, int D>
static int flash_launch_f32(const FlashArgs& a, long long blocks, cudaStream_t st) {
  const size_t smem = sizeof(float) * FlashTile<BQ, D>::SMEM_FLOATS;
  const int err = flash_set_smem(flash_fwd_kernel<BQ, D>, smem);
  if (err) return err;
  flash_fwd_kernel<BQ, D><<<(unsigned)blocks, FlashTile<BQ, D>::NT, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int BQ>
static int flash_dispatch_d(const FlashArgs& a, int d, long long blocks, cudaStream_t st) {
  switch (d) {
    case 16: return flash_launch_f32<BQ, 16>(a, blocks, st);
    case 32: return flash_launch_f32<BQ, 32>(a, blocks, st);
    case 64: return flash_launch_f32<BQ, 64>(a, blocks, st);
    case 128: return flash_launch_f32<BQ, 128>(a, blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// float32 q, k, v, o at block_q 8, 16 or 32 (flash_wgmma.cu serves 64 and
// 128, flash16_stacked.cu and flash16_wgmma.cu the 16-bit types).
extern "C" int flash_attention_launch(void* o, const void* q, const void* k, const void* v,
                                      const void* bias, int bias_b, int bias_h,
                                      const void* seg, int b, int hq, int hkv, int s, int d,
                                      int block_q, int folded, float scale, void* stream) {
  FlashArgs a;
  long long blocks;
  if (!flash_args(&a, o, q, k, v, bias, bias_b, bias_h, seg, b, hq, hkv, s, block_q, folded,
                  scale, &blocks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (block_q) {
    case 8: return flash_dispatch_d<8>(a, d, blocks, st);
    case 16: return flash_dispatch_d<16>(a, d, blocks, st);
    case 32: return flash_dispatch_d<32>(a, d, blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
