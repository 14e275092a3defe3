// Causal flash attention forward on the 2-simplex of (q tile, kv tile)
// pairs: float32 in and out, float32 online softmax, GQA without a
// repeated K/V tensor, optional additive bias and segment ids.
//
// Replaces: the TPU kernel of repro/kernels/flash_attention.py
// _flash_launch (kernel table row 5), a Pallas grid (B*Hq, pairs, nq+1)
// or (B*Hq, nq, nq) whose sequential last axis carried the running max,
// denominator and accumulator in VMEM scratch from one grid step to the
// next.
//
// The map on the GPU: blocks run in parallel and in no order, so the
// sequential grid axis becomes a loop inside the block.  One block per
// (b*Hq, pair p) for the folded schedule walks j = 0..nq:
//   j <= p: (q, kv) = (p, j);  j > p: (q, kv) = (nq-1-p, j-p-1),
// resetting at j == 0 | j == p+1 and flushing at j == p | j == nq, so
// each query tile's KV visits are consecutive and every block does
// nq+1 tile steps (an odd nq's middle pair recomputes and rewrites its
// own tile).  The bounding-box schedule has one block per (b*Hq, q tile)
// and walks its kv <= q tiles.  The KV row of bh is bh / (Hq/Hkv).
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
// two blocks (16 warps) share an SM at BQ = 128, D = 128 (101,888 bytes
// of shared memory each).
//
// Masked probabilities are zeroed, so a row with no visible key so far
// keeps l = 0 and its output becomes 0, never NaN.  The products carry
// float32 accuracy (each drops only small_q.small_k, below 2^-22 of the
// term), and the softmax over sub-chunks of a tile is the same online
// recurrence as over whole tiles, so the result differs from the plain
// version by float32 rounding only.  Element offsets are 64-bit.
#include <cuda_runtime.h>

#include "mma_tf32.cuh"

#define FLASH_NEG_INF (-1e30f)

struct FlashArgs {
  const float* q;     // (B*Hq, S, D)
  const float* k;     // (B*Hkv, S, D)
  const float* v;     // (B*Hkv, S, D)
  float* o;           // (B*Hq, S, D)
  const float* bias;  // (bias_b*bias_h, S, S) or null
  const int* seg;     // (B, S) or null
  int hq, group, s, nq, bias_b, bias_h, folded;
  float scale;
};

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

static __device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
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
  const int nq = a.nq, s = a.s;
  const int pairs = a.folded ? (nq + 1) / 2 : nq;
  const long long bh = blockIdx.x / pairs;
  const int p = (int)(blockIdx.x % pairs);
  const long long kvh = bh / a.group;
  const long long batch = bh / a.hq;
  const float* qb = a.q + bh * s * D;
  const float* kb = a.k + kvh * s * D;
  const float* vb = a.v + kvh * s * D;
  float* ob = a.o + bh * s * D;
  const float* bslab = nullptr;
  if (a.bias) {
    const long long head = bh % a.hq;
    const long long sb = a.bias_b > 1 ? batch % a.bias_b : 0;
    const long long sh = a.bias_h > 1 ? head % a.bias_h : 0;
    bslab = a.bias + (sb * a.bias_h + sh) * s * (long long)s;
  }
  const int* segb = a.seg ? a.seg + batch * s : nullptr;
  const int items = (a.folded ? nq + 1 : p + 1) * NCH;  // (step, sub-chunk) in order

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
    const bool diag = qt == kt;
    const int cbase = c * BC;  // tile-local column of the sub-chunk
    // Below the diagonal, with no bias or segments, every score is visible.
    const bool dense = BQ >= 16 && !diag && !segb && !bslab;
    unsigned valid = dense ? ~0u : 0u;
    float mx[2] = {FLASH_NEG_INF, FLASH_NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[nt][e];
        if (!dense) {
          const int rl = e < 2 ? rl0 : rl1;
          const int cl = cbase + nt * 8 + 2 * t + (e & 1);
          bool ok = rl < BQ && !(diag && cl > rl);
          const int row = qt * BQ + rl, col = kt * BQ + cl;
          if (ok && segb) ok = segb[row] == segb[col];
          if (ok && bslab) x += bslab[(long long)row * s + col];
          x = ok ? x : FLASH_NEG_INF;
          if (ok) valid |= 1u << (nt * 4 + e);
          sc[nt][e] = x;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], mn[2];
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
    for (int h = 0; h < 2; ++h) lrow[h] = lrow[h] * alpha[h] + ps[h];  // the lane's part
    if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f))  // a max moved
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

template <int BQ, int D>
static int flash_launch_t(const FlashArgs& a, long long blocks, cudaStream_t st) {
  const size_t smem = sizeof(float) * FlashTile<BQ, D>::SMEM_FLOATS;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<BQ, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  flash_fwd_kernel<BQ, D><<<(unsigned)blocks, FlashTile<BQ, D>::NT, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int BQ>
static int flash_dispatch_d(const FlashArgs& a, int d, long long blocks, cudaStream_t st) {
  switch (d) {
    case 16: return flash_launch_t<BQ, 16>(a, blocks, st);
    case 32: return flash_launch_t<BQ, 32>(a, blocks, st);
    case 64: return flash_launch_t<BQ, 64>(a, blocks, st);
    case 128: return flash_launch_t<BQ, 128>(a, blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_attention_launch(void* o, const void* q, const void* k, const void* v,
                                      const void* bias, int bias_b, int bias_h,
                                      const void* seg, int b, int hq, int hkv, int s, int d,
                                      int block_q, int folded, float scale, void* stream) {
  if (b < 1 || hkv < 1 || hq % hkv || block_q < 1 || s % block_q) return (int)cudaErrorInvalidValue;
  FlashArgs a;
  a.q = (const float*)q;
  a.k = (const float*)k;
  a.v = (const float*)v;
  a.o = (float*)o;
  a.bias = (const float*)bias;
  a.seg = (const int*)seg;
  a.hq = hq;
  a.group = hq / hkv;
  a.s = s;
  a.nq = s / block_q;
  a.bias_b = bias_b;
  a.bias_h = bias_h;
  a.folded = folded;
  a.scale = scale;
  const long long pairs = folded ? (a.nq + 1) / 2 : a.nq;
  const long long blocks = (long long)b * hq * pairs;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (block_q) {
    case 8: return flash_dispatch_d<8>(a, d, blocks, st);
    case 16: return flash_dispatch_d<16>(a, d, blocks, st);
    case 32: return flash_dispatch_d<32>(a, d, blocks, st);
    case 64: return flash_dispatch_d<64>(a, d, blocks, st);
    case 128: return flash_dispatch_d<128>(a, d, blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
