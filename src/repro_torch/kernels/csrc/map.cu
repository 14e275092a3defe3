// MAP: the schedule walk itself, (steps, m+1) int32 rows of
// (*coords, valid) — the paper's map-only microbenchmark (Fig. 10/13).
//
// Replaces: the TPU kernel of repro/kernels/engine.py MapBody.launch
// (kernel table row 1), whose Pallas program wrote `chunk` steps per
// grid step and clipped the padded tail to steps-1.
//
// Bound on the card: bytes written, steps * (m+1) * 4 (plus the table
// read for the table kind); the map itself is a few integer operations a
// step once it lives in registers (simplex_maps.cuh).
// Design: the kernel is templated on m, so a thread's x[m] and its row
// are registers.  A block of `threads` threads takes MAP_STEPS * threads
// consecutive steps; each thread evaluates the map for steps
// threadIdx.x, threadIdx.x + threads, ... of the block and puts its row
// in shared memory (one 16-byte store a piece where m+1 is a multiple of
// 4), then the block writes its rows out as one contiguous run of 16-byte
// pieces, neighbouring threads on neighbouring pieces, the last few ints
// of the run one by one.  Rows past `steps` are not written.  The output
// is the only traffic, so the write cannot be elided (the CUDA original
// used `volatile` for the same purpose).
#include "simplex_maps.cuh"

#define MAP_STEPS 4  // steps a thread
#define MAP_SMEM_DEFAULT (48 * 1024)  // shared memory a block gets without opting in

template <int M>
__global__ void simplex_map_kernel(int* __restrict__ out, const __grid_constant__ SimplexMap map) {
  extern __shared__ __align__(16) int stage[];  // MAP_STEPS * blockDim.x rows of M + 1
  constexpr int R = M + 1;
  const int per_block = MAP_STEPS * blockDim.x;
  const long long first = (long long)blockIdx.x * per_block;
  const int rows = (int)min((long long)per_block, map.steps - first);
#pragma unroll 1
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    int x[M];
    const int valid = simplex_map<M>(map, (int)(first + r), x);
    int v[R];
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] = j < M ? x[j] : valid;
    int* row = stage + r * R;
    if constexpr (R % 4 == 0) {
#pragma unroll
      for (int j = 0; j < R; j += 4)
        *reinterpret_cast<int4*>(row + j) = make_int4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j) row[j] = v[j];
    }
  }
  __syncthreads();
  int* dst = out + first * R;  // 16-byte aligned: per_block * R is a multiple of 4
  const int total = rows * R, pieces = total >> 2;
  for (int i = threadIdx.x; i < pieces; i += blockDim.x)
    reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(stage)[i];
  for (int i = 4 * pieces + threadIdx.x; i < total; i += blockDim.x) dst[i] = stage[i];
}

// out: (steps, m+1) int32 on a 16-byte boundary; threads: a block's threads.
extern "C" int simplex_map_launch(void* out, const long long* header, const void* data,
                                  int threads, void* stream) {
  SimplexMap M;
  if (!simplex_map_unpack(header, data, &M) || threads < 1 || threads > 1024 ||
      ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  if (M.steps == 0) return 0;
  const long long per_block = (long long)MAP_STEPS * threads;
  const unsigned blocks = (unsigned)((M.steps + per_block - 1) / per_block);
  const size_t smem = (size_t)per_block * (M.m + 1) * sizeof(int);
  cudaStream_t s = (cudaStream_t)stream;
#define SIMPLEX_MAP(MM)                                                                    \
  do {                                                                                     \
    if (smem > MAP_SMEM_DEFAULT) {                                                         \
      cudaError_t err = cudaFuncSetAttribute(                                              \
          simplex_map_kernel<MM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem); \
      if (err != cudaSuccess) return (int)err;                                             \
    }                                                                                      \
    simplex_map_kernel<MM><<<blocks, threads, smem, s>>>((int*)out, M);                    \
  } while (0)
  SIMPLEX_DISPATCH_M(M.m, SIMPLEX_MAP)
#undef SIMPLEX_MAP
  return (int)cudaGetLastError();
}
