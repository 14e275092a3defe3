// EDM: out[c] = sum_{a<b} ||p[c_a] - p[c_b]|| on the domain of an
// (n,)*m float32 array from (n, d) float32 points; the rest of the
// output stays the zeros it was allocated with.
//
// Replaces: the TPU kernel of repro/kernels/engine.py _launch_domain
// with EDMBody (kernel table row 3), which fetched the m (rho, d) point
// blocks of a step through BlockSpecs.
//
// Bound on the card: at m=2 the arithmetic — one d-wide distance per
// domain element, 3*d float32 operations against 67 TFLOP/s; at m >= 3
// the output bytes, since the m(m-1)/2 distances of a tile repeat
// across its rho^m elements.  Design: one block per schedule step;
// thread 0 evaluates the map and the block shares it; the block stages
// its m point blocks in shared memory (rows padded to d+1 floats, so the
// threads of a warp read distinct banks), computes the m(m-1)/2
// rho x rho distance matrices once into shared memory, then
// every element sums its pairs in the reference's order (a, then b > a)
// and writes if it lies in the domain.  Sums run in float32 in another
// order than XLA's and sqrtf rounds on the card, so results agree with
// the plain version to a tolerance, not bit for bit.
#include "simplex_maps.cuh"

template <int M>
__global__ void simplex_edm_kernel(float* __restrict__ out, const float* __restrict__ p,
                                   SimplexMap map, int n, int rho, int shift, int d) {
  extern __shared__ float smem[];
  __shared__ int s_blk[SIMPLEX_MAX_M + 1];
  if (!simplex_block_shared(map, s_blk)) return;
  int blk[M];
#pragma unroll
  for (int j = 0; j < M; ++j) blk[j] = s_blk[j];
  const int ld = d + 1;                // padded row: no bank conflicts
  float* pts = smem;                   // [M][rho][ld], coordinate a = x_a
  float* dist = smem + M * rho * ld;   // [pair][i_b][i_a]
  const int npts = M * rho * d;
  for (int e = threadIdx.x; e < npts; e += blockDim.x) {
    int k = e % d, i = (e / d) % rho, a = e / (d * rho);
    long long row = (long long)blk[M - 1 - a] * rho + i;  // x_a is axis M-1-a
    pts[(a * rho + i) * ld + k] = p[row * d + k];
  }
  __syncthreads();
  const int rr = rho * rho;
  constexpr int npairs = M * (M - 1) / 2;
  for (int e = threadIdx.x; e < npairs * rr; e += blockDim.x) {
    int pr = e / rr, ib = (e % rr) / rho, ia = e % rho;
    int a = 0, q = pr;  // pair index -> (a, b), a < b, a-major
    while (q >= M - 1 - a) { q -= M - 1 - a; ++a; }
    const int b = a + 1 + q;
    const float* pb = pts + (b * rho + ib) * ld;
    const float* pa = pts + (a * rho + ia) * ld;
    float s = 0.f;
    for (int k = 0; k < d; ++k) {
      float df = pb[k] - pa[k];
      s += df * df;
    }
    dist[e] = sqrtf(s);
  }
  __syncthreads();
  const int tile = simplex_ipow<M>(rho);
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    int g[M], l[M];
    int r = e;
#pragma unroll
    for (int j = M - 1; j >= 0; --j) {
      l[j] = simplex_split(r, rho, shift);
      g[j] = blk[j] * rho + l[j];
    }
    if (!simplex_in_domain<M>(g, n)) continue;
    float total = 0.f;
    int pr = 0;
#pragma unroll
    for (int a = 0; a < M; ++a)
#pragma unroll
      for (int b = a + 1; b < M; ++b, ++pr)
        total += dist[pr * rr + l[M - 1 - b] * rho + l[M - 1 - a]];
    out[simplex_offset<M>(g, n)] = total;
  }
}

// Shared memory of one block: padded point rows + the distance matrices.
static size_t simplex_edm_smem(int m, int rho, int d) {
  return sizeof(float) * ((size_t)m * rho * (d + 1) + (size_t)(m * (m - 1) / 2) * rho * rho);
}

extern "C" int simplex_edm_launch(void* out, const void* p, int d, const long long* header,
                                  const void* data, int n, int rho, void* stream) {
  SimplexMap M = simplex_map_from_header(header, (const int*)data);
  if (!simplex_map_ok(M) || rho < 1 || n % rho || d < 1) return (int)cudaErrorInvalidValue;
  if (M.steps == 0) return 0;
  const size_t smem = simplex_edm_smem(M.m, rho, d);
  int tile = 1;
  for (int j = 0; j < M.m; ++j) tile *= rho;
  int threads = tile < 1024 ? tile : 1024;
  if (threads < 32) threads = 32;
  const int shift = simplex_rho_shift(rho);
  cudaStream_t s = (cudaStream_t)stream;
#define SIMPLEX_EDM(MM)                                                          \
  do {                                                                           \
    if (smem > 48 * 1024) {                                                      \
      cudaError_t err = cudaFuncSetAttribute(                                    \
          simplex_edm_kernel<MM>, cudaFuncAttributeMaxDynamicSharedMemorySize,   \
          (int)smem);                                                            \
      if (err != cudaSuccess) return (int)err;                                   \
    }                                                                            \
    simplex_edm_kernel<MM><<<M.steps, threads, smem, s>>>(                       \
        (float*)out, (const float*)p, M, n, rho, shift, d);                      \
  } while (0)
  SIMPLEX_DISPATCH_M(M.m, SIMPLEX_EDM)
#undef SIMPLEX_EDM
  return (int)cudaGetLastError();
}
