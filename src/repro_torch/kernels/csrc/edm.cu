// EDM: out[c] = sum_{a<b} ||p[c_a] - p[c_b]|| on the domain of an
// (n,)*m array from (n, d) float32 points; the rest of the output stays
// the zeros it was allocated with.  As in the reference, the arithmetic
// is float32 whatever the points' type (the wrapper stages them as
// float32) and each cell is stored once in the output's type (float16,
// bfloat16, float32 or float64, a run-time code; dtypes.cuh's
// dt_store_float), rounded to nearest even, so a 16-bit output costs
// no second pass over the array.
//
// Replaces: the TPU kernel of repro/kernels/engine.py _launch_domain
// with EDMBody (kernel table row 3), which fetched the m (rho, d) point
// blocks of a step through BlockSpecs.
//
// Bound on the card: at m=2 the output bytes, one float32 per domain
// cell, against the arithmetic of the Gram form on the tensor cores
// (2d + 3 operations per distinct pair at the 3xTF32 rate of
// 495/3 TFLOP/s); at m >= 3 the output bytes, since the m(m-1)/2
// distances of a tile repeat across its rho^m cells.
//
// Design: one warp per schedule step, EDM_WARPS warps per block, each
// warp taking a run of EDM_RUN consecutive steps, so no block-wide
// barrier is paid per step; neighbouring steps of a map mostly share all
// blocks but one, and a block already staged is not loaded again.  Every
// lane evaluates the map (the lanes agree, so the warp does not
// diverge), the warp stages its m point blocks in its own slice of
// shared memory (rows padded to ld = 4 mod 8 floats, so the fragment
// loads of mma.sync hit 32 distinct banks), and for each pair (a, b)
// computes the rho x rho Gram tile G = P_b P_a^T on the tensor cores in
// 16x16 pieces with 3xTF32 mma.sync (mma_tf32.cuh): float32 accuracy at
// three MMAs per product.  Rows past rho and columns past d load as
// zeros.  The norms come from the same fragment registers (exact
// float32 FMAs of the unsplit values, reduced over each quad), and the
// accumulator fragments become s = |p_b|^2 + |p_a|^2 - 2 G.
//
// Cancellation guard: the Gram form loses what the norms share.  With
// unit roundoff u = 2^-24, the norms carry an error up to about d u
// (|a|^2 + |b|^2) and the 3xTF32 product, which drops small_a.small_b
// and rounds each small part (each below 2^-22 |a_k b_k|), up to about
// (3 * 2^-22 + d u) |a||b| <= (12 + d) u (|a|^2 + |b|^2) / 2, twice that
// in 2 a.b.  So |err s| <= gamma (|a|^2 + |b|^2) with gamma ~ (2d + 12) u
// (8.3e-6 at d = 64 in the worst case, near sqrt(d) u for random
// signs), and the
// relative error of sqrt(s) is at most gamma (|a|^2 + |b|^2) / (2 s).
// Where s >= tau (|a|^2 + |b|^2) that is gamma / (2 tau), which at
// tau = 1/2 is gamma: below the 1e-5 relative gate at d = 64 even in the
// worst case.  Below it (near points, and c_a == c_b, where the Gram form
// gives about sqrt(gamma) (|a| + |b|) instead of 0) the lane recomputes
// the pair in the difference form sum_k (p_b[k] - p_a[k])^2 from the
// staged rows, which is exact at 0.  A negative s lies below the guard,
// so no square root of one is taken.  For random points in d = 64, s
// falls below (|a|^2 + |b|^2) / 2 about four standard deviations from
// its mean, so the guard costs little.
//
// At m=2 each lane writes its fragment's distances straight to the
// output; at m >= 3 the pair distances go to the warp's shared slice
// and every cell sums its pairs in the reference's order (a, then
// b > a).  Only domain cells are written.  Sums run in float32 in
// another order than the plain version's and sqrtf rounds on the card,
// so results agree with it to a tolerance, not bit for bit.
#include "dtypes.cuh"
#include "mma_tf32.cuh"
#include "simplex_maps.cuh"

#define EDM_WARPS 4
#define EDM_RUN 8  // consecutive steps a warp takes: neighbours share blocks
#define EDM_SMEM_LIMIT 232448  // a Hopper block's shared memory, bytes
#define EDM_GUARD 0.5f         // tau of the cancellation guard

// Floats of one warp's slice: the staged rows, then at m >= 3 the pair
// distance matrices (kernels/engine.py mirrors this and simplex_edm_ld).
static size_t simplex_edm_warp_floats(int m, int rho, int ld) {
  size_t f = (size_t)m * rho * ld;
  if (m > 2) f += (size_t)(m * (m - 1) / 2) * rho * rho;
  return (f + 3) & ~(size_t)3;  // keep every warp's slice 16-byte aligned
}

// Row stride of the staged points: the least ld >= d with ld % 8 == 4
// (conflict-free fragment loads), or d itself when that layout would not
// fit one warp's slice.
static int simplex_edm_ld(int m, int rho, int d) {
  const int ld = d + ((12 - d % 8) % 8);
  return sizeof(float) * simplex_edm_warp_floats(m, rho, ld) <= (size_t)EDM_SMEM_LIMIT ? ld : d;
}

// The 16x16 piece (rows r0.., columns c0..) of the Gram tile of staged
// point rows pb (rows) and pa (columns), with the squared norms of the
// lane's rows (nb[0]: r0+g, nb[1]: r0+g+8) and of the piece's columns
// (na[j]: column c0 + 8j + g).
static __device__ __forceinline__ void edm_gram16(const float* pb, const float* pa, int ld,
                                                  int d, int rho, int r0, int c0, int g, int t,
                                                  float acc[2][4], float nb[2], float na[2]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    nb[j] = na[j] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  const bool two = c0 + 8 < rho;  // uniform: the second 8-column piece is live
  const bool okA0 = r0 + g < rho, okA1 = r0 + g + 8 < rho;
  const bool okB0 = c0 + g < rho, okB1 = two && c0 + 8 + g < rho;
  const float* A0 = pb + (r0 + g) * ld;
  const float* A1 = A0 + 8 * ld;
  const float* B0 = pa + (c0 + g) * ld;
  const float* B1 = B0 + 8 * ld;
  for (int k0 = 0; k0 < d; k0 += 8) {
    const int k1 = k0 + t, k2 = k0 + t + 4;
    const bool in1 = k1 < d, in2 = k2 < d;
    const float a0 = okA0 && in1 ? A0[k1] : 0.f, a1 = okA1 && in1 ? A1[k1] : 0.f;
    const float a2 = okA0 && in2 ? A0[k2] : 0.f, a3 = okA1 && in2 ? A1[k2] : 0.f;
    FragA fa;
    frag_a(fa, a0, a1, a2, a3);
    nb[0] = fmaf(a2, a2, fmaf(a0, a0, nb[0]));
    nb[1] = fmaf(a3, a3, fmaf(a1, a1, nb[1]));
    const float b0 = okB0 && in1 ? B0[k1] : 0.f, b1 = okB0 && in2 ? B0[k2] : 0.f;
    const float b2 = okB1 && in1 ? B1[k1] : 0.f, b3 = okB1 && in2 ? B1[k2] : 0.f;
    FragB fb[2];
    frag_b(fb[0], b0, b1);
    frag_b(fb[1], b2, b3);
    na[0] = fmaf(b1, b1, fmaf(b0, b0, na[0]));
    na[1] = fmaf(b3, b3, fmaf(b2, b2, na[1]));
    if (two)
      mma3<2>(acc, fa, fb);
    else
      mma3<1>(acc, fa, fb);
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {  // a row's or column's k spans its quad
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      nb[j] += __shfl_xor_sync(0xffffffffu, nb[j], off);
      na[j] += __shfl_xor_sync(0xffffffffu, na[j], off);
    }
  }
}

// ||pb[r] - pa[c]|| from s = |pb[r]|^2 + |pa[c]|^2 - 2 pb[r].pa[c], in
// the difference form below the guard.
static __device__ __forceinline__ float edm_distance(float s, float nr, float nc,
                                                     const float* pb, const float* pa,
                                                     int ld, int d, int r, int c) {
  if (s < EDM_GUARD * (nr + nc)) {
    const float* x = pb + r * ld;
    const float* y = pa + c * ld;
    s = 0.f;
    for (int k = 0; k < d; ++k) {
      const float df = x[k] - y[k];
      s = fmaf(df, df, s);
    }
  }
  return sqrtf(s);
}

template <int M>
__global__ void __launch_bounds__(EDM_WARPS * 32)
simplex_edm_kernel(void* __restrict__ out, int out_dtype, const float* __restrict__ p,
                   const __grid_constant__ SimplexMap map, int n, int rho, int shift, int d,
                   int ld, int warp_floats) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* pts = smem + (size_t)warp * warp_floats;  // [M][rho][ld], block a = x_a
  float* dist = pts + M * rho * ld;                // m >= 3: [pair][i_b][i_a]
  const int rr = rho * rho;
  // Staging: rows of dv vectors (float4 where rows allow), lpr lanes a row.
  const bool vec = (d & 3) == 0 && (ld & 3) == 0;
  const int dv = vec ? d >> 2 : d;
  const int lpr = dv < 32 ? dv : 32;
  const int rows_per = 32 / lpr, my_r = lane / lpr, my_k = lane - my_r * lpr;
  int staged[M];  // block coordinate of each slot, -1 before the first
#pragma unroll
  for (int a = 0; a < M; ++a) staged[a] = -1;
  const long long base = ((long long)blockIdx.x * nwarps + warp) * EDM_RUN;
  const int last = (int)min((long long)map.steps, base + EDM_RUN);
  for (int step = (int)base; step < last; ++step) {
    int x[M];
    if (!simplex_map<M>(map, step, x)) continue;  // the same answer in every lane
    int blk[M];
#pragma unroll
    for (int j = 0; j < M; ++j) blk[j] = x[M - 1 - j];
    unsigned fresh = 0;  // slots whose block differs from the staged one
#pragma unroll
    for (int a = 0; a < M; ++a) {
      if (x[a] != staged[a]) fresh |= 1u << a;
      staged[a] = x[a];
    }
    __syncwarp();  // the previous step's reads of pts and dist are done
    if (fresh && my_r < rows_per) {
      for (int rw = my_r; rw < M * rho; rw += rows_per) {
        int a, i;
        if (shift >= 0) {
          a = rw >> shift;
          i = rw & (rho - 1);
        } else {
          a = rw / rho;
          i = rw - a * rho;
        }
        if (!((fresh >> a) & 1u)) continue;
        int ba = 0;
#pragma unroll
        for (int j = 0; j < M; ++j)
          if (j == a) ba = x[j];
        const float* src = p + ((long long)ba * rho + i) * d;
        float* dst = pts + rw * ld;
        if (vec) {
          for (int k = my_k; k < dv; k += lpr)
            reinterpret_cast<float4*>(dst)[k] = __ldg(reinterpret_cast<const float4*>(src) + k);
        } else {
          for (int k = my_k; k < dv; k += lpr) dst[k] = __ldg(src + k);
        }
      }
    }
    __syncwarp();
    int pr = 0;
#pragma unroll
    for (int a = 0; a < M; ++a) {
#pragma unroll
      for (int b = a + 1; b < M; ++b, ++pr) {
        const float* pa = pts + a * rho * ld;
        const float* pb = pts + b * rho * ld;
        for (int r0 = 0; r0 < rho; r0 += 16) {
          for (int c0 = 0; c0 < rho; c0 += 16) {
            float acc[2][4], nb[2], na[2];
            edm_gram16(pb, pa, ld, d, rho, r0, c0, g, t, acc, nb, na);
            float nc[2][2];  // norm of column c0 + 8j + 2t + e, from lane (2t + e) * 4
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                nc[j][e] = __shfl_sync(0xffffffffu, na[j], (2 * t + e) * 4);
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int r = r0 + g + (e >> 1) * 8, c = c0 + 8 * j + 2 * t + (e & 1);
                if (r >= rho || c >= rho) continue;
                const float nr = nb[e >> 1], ncol = nc[j][e & 1];
                const float dd = edm_distance(nr + ncol - 2.f * acc[j][e], nr, ncol, pb, pa,
                                              ld, d, r, c);
                if (M == 2) {  // rows: axis 0 (x_1 = b), columns: axis 1 (x_0 = a)
                  const int g0 = blk[0] * rho + r, g1 = blk[1] * rho + c;
                  if (g1 <= g0) dt_store_float(out, (long long)g0 * n + g1, out_dtype, dd);
                } else {
                  dist[pr * rr + r * rho + c] = dd;
                }
              }
          }
        }
      }
    }
    if (M == 2) continue;
    __syncwarp();
    const int tile = simplex_ipow<M>(rho);
    for (int e = lane; e < tile; e += 32) {
      int gg[M], l[M];
      int r = e;
#pragma unroll
      for (int j = M - 1; j >= 0; --j) {
        l[j] = simplex_split(r, rho, shift);
        gg[j] = blk[j] * rho + l[j];
      }
      if (!simplex_in_domain<M>(gg, n)) continue;
      float total = 0.f;
      int q = 0;
#pragma unroll
      for (int a = 0; a < M; ++a)
#pragma unroll
        for (int b = a + 1; b < M; ++b, ++q)
          total += dist[q * rr + l[M - 1 - b] * rho + l[M - 1 - a]];
      dt_store_float(out, simplex_offset<M>(gg, n), out_dtype, total);
    }
  }
}

// out_dtype: the floating code of dtypes.cuh the output is stored in
// (kernels/policy.py DTYPE_CODES); the points are float32.
extern "C" int simplex_edm_launch(void* out, int out_dtype, const void* p, int d,
                                  const long long* header, const void* data, int n, int rho,
                                  void* stream) {
  SimplexMap M;
  if (!simplex_map_unpack(header, data, &M) || rho < 1 || n % rho || d < 1 ||
      !dt_float_ok(out_dtype))
    return (int)cudaErrorInvalidValue;
  if (M.steps == 0) return 0;
  const int ld = simplex_edm_ld(M.m, rho, d);
  const size_t warp_floats = simplex_edm_warp_floats(M.m, rho, ld);
  if (sizeof(float) * warp_floats > EDM_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  int warps = EDM_WARPS;
  while (warps > 1 && sizeof(float) * warp_floats * warps > EDM_SMEM_LIMIT) --warps;
  const size_t smem = sizeof(float) * warp_floats * warps;
  const int shift = simplex_rho_shift(rho);
  const long long runs = ((long long)M.steps + EDM_RUN - 1) / EDM_RUN;
  const unsigned grid = (unsigned)((runs + warps - 1) / warps);  // one run a warp
  cudaStream_t s = (cudaStream_t)stream;
#define SIMPLEX_EDM(MM)                                                               \
  do {                                                                                \
    if (smem > 48 * 1024) {                                                           \
      cudaError_t err = cudaFuncSetAttribute(                                         \
          simplex_edm_kernel<MM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem); \
      if (err != cudaSuccess) return (int)err;                                        \
    }                                                                                 \
    simplex_edm_kernel<MM><<<grid, warps * 32, smem, s>>>(                            \
        out, out_dtype, (const float*)p, M, n, rho, shift, d, ld, (int)warp_floats);  \
  } while (0)
  SIMPLEX_DISPATCH_M(M.m, SIMPLEX_EDM)
#undef SIMPLEX_EDM
  return (int)cudaGetLastError();
}
