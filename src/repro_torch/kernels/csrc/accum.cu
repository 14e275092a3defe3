// ACCUM: +1 on every domain element of an (n,)*m array, in place.
//
// Replaces: the TPU kernel of repro/kernels/engine.py _launch_domain
// with AccumBody.tile (kernel table row 2).  On the TPU every grid step
// flushes its block, so invalid steps parked on a trash tile and the
// input was aliased to the output; here an invalid step returns at once
// and the kernel updates the buffer it is given.  The functional
// accum(x) copies x first; accum_(x) updates x itself.
//
// Bound on the card: memory.  Each domain element is read once and
// written once, 2 * V * sizeof(T) bytes at 3.35 TB/s; there is one add
// per element, in the array's own arithmetic (dtypes.cuh: integers wrap,
// 16-bit floats round to nearest even; the type is a run-time code, the
// same in every thread).  Design: one block per schedule step (the paper's
// blockIdx -> H -> data block); thread 0 evaluates the map and the block
// shares it; threads cover the rho^m tile with the last array axis
// fastest so neighbouring threads touch neighbouring addresses.  The
// kernel is templated on m so the per-element index loops unroll into
// registers, and a power-of-two rho is split by shifts, not divisions.
// Element offsets are int64 (an m=3, n=1024 int32 array is 4 GiB).
#include "dtypes.cuh"
#include "simplex_maps.cuh"

template <int M>
__global__ void simplex_accum_kernel(void* __restrict__ x, int dtype, SimplexMap map, int n,
                                     int rho, int shift) {
  __shared__ int s_blk[SIMPLEX_MAX_M + 1];
  if (!simplex_block_shared(map, s_blk)) return;
  int blk[M];
#pragma unroll
  for (int j = 0; j < M; ++j) blk[j] = s_blk[j];
  const int tile = simplex_ipow<M>(rho);
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    int g[M];
    int r = e;
#pragma unroll
    for (int j = M - 1; j >= 0; --j) g[j] = blk[j] * rho + simplex_split(r, rho, shift);
    if (simplex_in_domain<M>(g, n)) {
      long long off = simplex_offset<M>(g, n);
      dt_add_one(x, off, dtype);
    }
  }
}

// dtype: a code of dtypes.cuh that ACCUM takes (kernels/policy.py DTYPE_CODES).
extern "C" int simplex_accum_launch(void* x, int dtype, const long long* header,
                                    const void* data, int n, int rho, void* stream) {
  SimplexMap M = simplex_map_from_header(header, (const int*)data);
  if (!simplex_map_ok(M) || rho < 1 || n % rho || !dt_accum_ok(dtype))
    return (int)cudaErrorInvalidValue;
  if (M.steps == 0) return 0;
  int tile = 1;
  for (int j = 0; j < M.m; ++j) tile *= rho;
  const int threads = tile < 1024 ? tile : 1024;
  const int shift = simplex_rho_shift(rho);
  cudaStream_t s = (cudaStream_t)stream;
#define SIMPLEX_ACCUM(MM) \
  simplex_accum_kernel<MM><<<M.steps, threads, 0, s>>>(x, dtype, M, n, rho, shift)
  SIMPLEX_DISPATCH_M(M.m, SIMPLEX_ACCUM)
#undef SIMPLEX_ACCUM
  return (int)cudaGetLastError();
}
