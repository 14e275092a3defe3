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
// and walks all nq KV tiles, skipping kv > q.  The KV row of bh is
// bh / (Hq/Hkv).
//
// Bound on the card: float32 arithmetic.  A (BQ x BQ) tile pair costs
// 4*BQ*BQ*D operations against 2*BQ*D*4 bytes of K and V, BQ/2
// operations a byte, so from BQ = 64 up (above the card's 20 float32
// operations a byte) the FMA units, not the memory, are the limit.  Design: a
// schedule tile of BQ query rows is covered by NT = (BQ/4) * (BC/4)
// threads, each owning 4 query rows; the KV tile is streamed through
// shared memory in sub-chunks of BC = min(32, BQ) keys, so BQ = 128 at
// D = 128 fits (116 KB: Q transposed, one K sub-chunk transposed, one V
// sub-chunk, the P sub-tile).  Each thread computes a 4x4 score
// micro-tile from float4 reads of Q and K (16 FMAs per 2 shared loads),
// the row max and sum run over the BC/4 threads of a row group with
// warp shuffles, and P @ V accumulates a 4 x D/(BC/4) slice of the
// output in registers.  No tensor cores (float32 FMA only), no TMA, no
// double buffering: a simple kernel that is right, to be made fast
// later.  The softmax over sub-chunks of a tile is the same online
// recurrence as over whole tiles, so the result differs from the
// reference by float32 rounding only.
//
// Masked probabilities are zeroed, so a row with no visible key so far
// keeps l = 0 and its output becomes 0, never NaN.  Element offsets are
// 64-bit.
#include <cuda_runtime.h>

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

template <int BQ>
struct FlashTile {
  static constexpr int BC = BQ < 32 ? BQ : 32;  // keys per sub-chunk
  static constexpr int G = BC / 4;              // threads per row group
  static constexpr int NT = (BQ / 4) * G;       // threads per block
  static constexpr int QST = BQ + 4;            // padded row of Q^T
  static constexpr int KST = BC + 4;            // padded row of K^T
};

template <int BQ, int D>
__host__ __device__ constexpr int flash_smem_floats() {
  return D * FlashTile<BQ>::QST + D * FlashTile<BQ>::KST + FlashTile<BQ>::BC * D +
         FlashTile<BQ>::BC * BQ;
}

template <int BQ, int D>
__global__ void __launch_bounds__(FlashTile<BQ>::NT)
flash_fwd_kernel(FlashArgs a) {
  using T = FlashTile<BQ>;
  constexpr int BC = T::BC, G = T::G, NT = T::NT, QST = T::QST, KST = T::KST;
  constexpr int DG = D / G;  // output columns per thread: cg + G*c
  constexpr unsigned MASK = NT >= 32 ? 0xffffffffu : ((1u << NT) - 1u);
  extern __shared__ __align__(16) float smem[];
  float* qt_s = smem;               // [D][QST]  scaled Q^T
  float* kt_s = qt_s + D * QST;     // [D][KST]  K^T of one sub-chunk
  float* v_s = kt_s + D * KST;      // [BC][D]   V of one sub-chunk
  float* p_s = v_s + BC * D;        // [BC][BQ]  P^T of one sub-chunk

  const int t = threadIdx.x, rg = t / G, cg = t % G;
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

  float m[4], l[4], acc[4][DG];
  const int steps = a.folded ? nq + 1 : nq;
  for (int j = 0; j < steps; ++j) {
    int qt, kt;
    bool start, last;
    if (a.folded) {
      const bool second = j > p;
      qt = second ? nq - 1 - p : p;
      kt = second ? j - p - 1 : j;
      start = j == 0 || j == p + 1;
      last = j == p || j == nq;
    } else {
      qt = p;
      kt = j;
      if (kt > qt) continue;  // the bounding box's dead upper half
      start = j == 0;
      last = j == qt;
    }
    if (start) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        m[i] = FLASH_NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < DG; ++c) acc[i][c] = 0.f;
      }
      __syncthreads();  // every read of the previous Q tile is done
      const float* qsrc = qb + (long long)qt * BQ * D;
      for (int e = t; e < BQ * D; e += NT) {
        const int r = e / D, d = e % D;
        qt_s[d * QST + r] = qsrc[e] * a.scale;
      }
    }
    for (int k0 = kt * BQ; k0 < kt * BQ + BQ; k0 += BC) {
      __syncthreads();  // the previous sub-chunk's K, V and P are consumed
      const float* ksrc = kb + (long long)k0 * D;
      const float* vsrc = vb + (long long)k0 * D;
      for (int e = t; e < BC * D; e += NT) {
        const int c = e / D, d = e % D;
        kt_s[d * KST + c] = ksrc[e];
        v_s[e] = vsrc[e];
      }
      __syncthreads();

      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sc[i][jj] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float4 qa = *reinterpret_cast<const float4*>(qt_s + d * QST + rg * 4);
        const float4 ka = *reinterpret_cast<const float4*>(kt_s + d * KST + cg * 4);
        const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
        const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) sc[i][jj] = fmaf(qv[i], kv[jj], sc[i][jj]);
      }

      const bool diag = qt == kt;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = qt * BQ + rg * 4 + i;
        bool valid[4];
        float mc = FLASH_NEG_INF;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int col = k0 + cg * 4 + jj;
          float x = sc[i][jj];
          if (bslab) x += bslab[(long long)row * s + col];
          bool ok = !(diag && col > row);
          if (segb) ok = ok && segb[row] == segb[col];
          valid[jj] = ok;
          x = ok ? x : FLASH_NEG_INF;
          sc[i][jj] = x;
          mc = fmaxf(mc, x);
        }
#pragma unroll
        for (int off = 1; off < G; off <<= 1) mc = fmaxf(mc, __shfl_xor_sync(MASK, mc, off));
        const float mn = fmaxf(m[i], mc);
        const float alpha = expf(m[i] - mn);
        float ps = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float pr = valid[jj] ? expf(sc[i][jj] - mn) : 0.f;
          sc[i][jj] = pr;
          ps += pr;
        }
#pragma unroll
        for (int off = 1; off < G; off <<= 1) ps += __shfl_xor_sync(MASK, ps, off);
        l[i] = l[i] * alpha + ps;
        m[i] = mn;
#pragma unroll
        for (int c = 0; c < DG; ++c) acc[i][c] *= alpha;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        *reinterpret_cast<float4*>(p_s + (cg * 4 + jj) * BQ + rg * 4) =
            make_float4(sc[0][jj], sc[1][jj], sc[2][jj], sc[3][jj]);
      __syncthreads();

#pragma unroll 4
      for (int c = 0; c < BC; ++c) {
        const float4 pr = *reinterpret_cast<const float4*>(p_s + c * BQ + rg * 4);
        const float* vrow = v_s + c * D + cg;
#pragma unroll
        for (int x = 0; x < DG; ++x) {
          const float vv = vrow[G * x];
          acc[0][x] = fmaf(pr.x, vv, acc[0][x]);
          acc[1][x] = fmaf(pr.y, vv, acc[1][x]);
          acc[2][x] = fmaf(pr.z, vv, acc[2][x]);
          acc[3][x] = fmaf(pr.w, vv, acc[3][x]);
        }
      }
    }
    if (last) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float li = l[i] == 0.f ? 1.f : l[i];
        float* orow = ob + (long long)(qt * BQ + rg * 4 + i) * D + cg;
#pragma unroll
        for (int x = 0; x < DG; ++x) orow[G * x] = acc[i][x] / li;
      }
    }
  }
}

template <int BQ, int D>
static int flash_launch_t(const FlashArgs& a, long long blocks, cudaStream_t st) {
  const size_t smem = sizeof(float) * flash_smem_floats<BQ, D>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<BQ, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  flash_fwd_kernel<BQ, D><<<(unsigned)blocks, FlashTile<BQ>::NT, smem, st>>>(a);
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
