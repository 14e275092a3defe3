// MAP: the schedule walk itself, (steps, m+1) int32 rows of
// (*coords, valid) — the paper's map-only microbenchmark (Fig. 10/13).
//
// Replaces: the TPU kernel of repro/kernels/engine.py MapBody.launch
// (kernel table row 1), whose Pallas program wrote `chunk` steps per
// grid step and clipped the padded tail to steps-1.
//
// Bound on the card: bytes written, steps * (m+1) * 4 (plus the table
// read for the table kind); the map itself is a few integer ops per step.
// Design: one thread per step, `chunk` threads per block, threads past
// `steps` return; each thread writes its m+1 int32s.  The output is the
// only traffic, so the write cannot be elided (the CUDA original used
// `volatile` for the same purpose).
#include "simplex_maps.cuh"

__global__ void simplex_map_kernel(int* __restrict__ out, SimplexMap M) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M.steps) return;
  int x[SIMPLEX_MAX_M];
  bool valid = simplex_map(M, (int)i, x);
  int* row = out + i * (M.m + 1);
  for (int j = 0; j < M.m; ++j) row[j] = x[j];
  row[M.m] = valid ? 1 : 0;
}

extern "C" int simplex_map_launch(void* out, const long long* header,
                                  const void* data, int threads, void* stream) {
  SimplexMap M = simplex_map_from_header(header, (const int*)data);
  if (!simplex_map_ok(M) || threads < 1 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  if (M.steps == 0) return 0;
  unsigned blocks = (unsigned)((M.steps + (long long)threads - 1) / threads);
  simplex_map_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>((int*)out, M);
  return (int)cudaGetLastError();
}
