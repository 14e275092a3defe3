// Causal flash attention forward, bfloat16 and float16, on Hopper's
// warpgroup MMA: 64- and 128-row tiles.  Float32 online softmax, GQA
// without a repeated K/V tensor, optional additive float32 bias and
// segment ids; the walk of the 2-simplex of (q tile, kv tile) pairs is
// flash_common.cuh's.
//
// Replaces: the TPU kernel of repro/kernels/flash_attention.py
// _flash_launch (kernel table row 5b) for bfloat16 and float16 at
// block_q in {64, 128} (flash_attention.cu keeps the 16-bit types at the
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
// Numerics, the reference's float32 arithmetic on 16-bit inputs (as
// flash_attention.cu's flash16_fwd_kernel):
// - S = Q K^T is one wgmma in the input type with float32 accumulators:
//   the product of two bf16 or f16 values is exact in float32.  The scale
//   multiplies the float32 scores after the product, in softmax16.
// - P stays float32-accurate as two parts of the input type, hi = round(P)
//   and lo = round(P - hi): O += lo V + hi V, two wgmmas a 16-key step.
//
// Design (BQ / 64 consumer warpgroups, 128 or 256 threads; what held the
// mma.sync kernel back was 16-key sub-chunks, a block barrier and a
// cp.async wait each, 32-bit fragment loads and small MMAs that never
// overlapped the loads or the softmax):
// - Layout: Q, K and V in shared memory as they are, in wgmma's 128-byte
//   swizzle: rows of 128 bytes (64 elements), 8-row atoms of 1024 bytes,
//   the 16-byte piece c of row r at piece (c % 8) ^ (r % 8), atoms along
//   D at a stride of rows * 128 bytes (f16_swz).  D < 64 fills part of
//   one atom.  Q and K are K-major operands of S; V, stored the same way
//   ([key][d]), is the MN-major B operand of PV through the transpose-B
//   immediate that 16-bit wgmma has: no transposing copy.
// - Copies: 64-key chunks of K and V through a ring of F16_STAGES stages,
//   every thread issuing 16-byte cp.async straight to the swizzled
//   addresses; a chunk is in flight for the whole of the chunk before it.
//   After a thread's copies land it fences them to the async proxy, and
//   one block barrier a chunk publishes them and frees the stage of the
//   chunk two back, which the next copy refills.  Q is loaded once per
//   query tile (unrolled 16-byte loads, a second barrier).
// - S = Q K^T: per warpgroup, D/16 m64n64k16 wgmmas with both operands
//   from shared memory (descriptors: SBO 1024, the 8-row groups).
// - Softmax on the accumulators (softmax16): masks, bias, segment ids,
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

#define F16_BN 64     // keys a chunk
#define F16_STAGES 3  // chunks in the ring

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

// --- the softmax --------------------------------------------------------------

static __device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One 64-key chunk's scores through the mask and the online softmax, in
// the log2 domain: x = (s * scale + bias) * log2(e), P = 2^(x - max), so
// each probability is one FFMA and one ex2 (flash_softmax's expf is a
// dozen instructions, and this elementwise work, not the MMAs, bounds
// the kernel).  ex2.approx is within 2 ulp of float32, far below the
// 16-bit output's rounding.  sc[4i + e] is row rl0 (e < 2) or rl0 + 8,
// key cbase + 8i + 2t + (e & 1); mrow holds the row max in log2 units.
// The causal and segment masks and the bias apply off the dense case as
// in flash_softmax; masked probabilities are 0, so a row with no visible
// key keeps l = 0.  Row max and sums are trees, not chains.
static __device__ __forceinline__ void softmax16(float* sc, const FlashArgs& a,
                                                 const FlashSlab& sl, int block, int qt,
                                                 int kt, int rl0, int cbase, int t,
                                                 float* mrow, float* lrow, float* alpha) {
  constexpr float LOG2E = 1.4426950408889634f;
  constexpr int N = F16_BN / 2;  // scores a thread
  const int rl1 = rl0 + 8;
  const bool diag = qt == kt;
  const bool dense = !diag && !sl.seg && !sl.bias;
  unsigned valid = ~0u;
  if (dense) {
    const float sl2 = a.scale * LOG2E;
#pragma unroll
    for (int i = 0; i < N; ++i) sc[i] *= sl2;
  } else {
    valid = 0u;
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
  }
  float mx[2][N / 4];  // [row half][partial]
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

// --- the kernel -------------------------------------------------------------

template <int BQ, int D, typename T>
__global__ void __launch_bounds__(Wg16Tile<BQ, D>::NT, 1)
flash16_wgmma_kernel(FlashArgs a) {
  using Tl = Wg16Tile<BQ, D>;
  using W = Wg16<T>;
  using Parts = Flash16Parts<T>;
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

    // S = Q K^T: D/16 k-steps of 32 bytes, atom ks / 4 of each row; then,
    // as its own group, O += lo V + hi V of chunk it-1.
    float sc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;  // overwritten: the first wgmma has scale_d = 0
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int qo = (ks >> 2) * BQ * 128 + wg * 64 * 128 + (ks & 3) * 32;
      const int ko = (ks >> 2) * BN * 128 + (ks & 3) * 32;
      W::ss(sc, f16_desc(q_s + qo, 16), f16_desc(kc + ko, 16), ks > 0);
    }
    wg_commit();
    if (has_p) {
      pv<W, NV>(o, hi, lo, v_s + ((it - 1) % F16_STAGES) * Tl::KV_BYTES);
      wg_wait<1>();  // S is done; PV may still run
    } else {
      wg_wait<0>();
    }
    wg_pin(sc);

    // Scale, bias and masks on the accumulators, then the online softmax.
    float alpha[2];
    softmax16(sc, a, sl, BQ, qt, kt, rl0, c * BN, t, mrow, lrow, alpha);
    if (has_p) {  // PV of chunk it-1 done: O and P's registers are free
      wg_wait<0>();
      wg_pin(o);
      wg_pin(hi);
      wg_pin(lo);
    }
    if (flash_moved(alpha))
#pragma unroll
      for (int e = 0; e < NV / 2; ++e) o[e] *= alpha[(e >> 1) & 1];

    // P's parts as the A fragment of k-step j: register f holds row g
    // (f even) or g+8, keys 16j + 8(f / 2) + 2t, +1 = sc[8j + 2f], sc[8j + 2f + 1].
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
#pragma unroll
      for (int f = 0; f < 4; ++f)
        Parts::split2(sc[8 * j + 2 * f], sc[8 * j + 2 * f + 1], hi[j][f], lo[j][f]);
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
              Parts::pack(o[4 * n + 2 * h] / li, o[4 * n + 2 * h + 1] / li);
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
