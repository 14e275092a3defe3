// ACCUM: +1 on every domain element of an (n,)*m array, in place.
//
// Replaces: the TPU kernel of repro/kernels/engine.py _launch_domain
// with AccumBody.tile (kernel table row 2).  On the TPU every grid step
// flushes its block, so invalid steps parked on a trash tile and the
// input was aliased to the output; here an invalid step writes nothing
// and the kernel updates the buffer it is given.  The functional
// accum(x) copies x first; accum_(x) updates x itself.
//
// Bound on the card: memory.  Each domain element is read once and
// written once, 2 * V * sizeof(T) bytes at 3.35 TB/s; there is one add
// per element, in the array's own arithmetic (dtypes.cuh: integers wrap,
// 16-bit floats round to nearest even).
//
// Design, for Hopper's memory system:
// - One warp per schedule step (the paper's step -> H -> data block),
//   ACCUM_WARPS steps a block.  Lane 0 evaluates the map once for the
//   step and broadcasts the block coordinates with __shfl_sync: no shared
//   memory and no block barrier, and an invalid step's warp returns.
// - The element type is a run-time code, switched once per warp after
//   the map into a body typed throughout, so the map is inlined once per
//   m (its copies, not the types, make the build slow).
// - 16-byte accesses: where a tile row of rho elements is a whole number
//   of 16-byte pieces and the array starts on a 16-byte boundary (the
//   host's fixed rule, engine.accum_vector_access), each lane reads and
//   writes whole pieces, up to ACCUM_UNROLL at a time (their loads in
//   flight together), the last axis fastest so a warp covers whole rows.
// - Occupancy: the map alone would take 96 registers a thread and leave
//   16 warps an SM; capped at 64 (ACCUM_BLOCKS) with two pieces in flight
//   a lane, 32 warps an SM keep more bytes in flight and nothing spills
//   (four pieces a lane at that cap spill).
//   A piece whose first element lies off the domain is not touched; in a
//   piece on the domain's edge the elements past it are written back
//   unchanged, which is safe because a data block belongs to exactly one
//   step.  Otherwise each lane takes single elements (the scalar path).
// Element offsets are int64 (an m=3, n=1024 int32 array is 4 GiB).
#include <stdint.h>

#include "dtypes.cuh"
#include "simplex_maps.cuh"

#define ACCUM_WARPS 8   // schedule steps (warps) a block
#define ACCUM_BLOCKS 4  // blocks an SM: at most 64 registers a thread
#define ACCUM_UNROLL 2  // 16-byte pieces a lane has in flight

// Domain elements from array-axis coordinates g along the last axis:
// g, g + e_last, ... are on the domain for the first accum_run of them.
template <int M>
static __device__ __forceinline__ int accum_run(const int* g, int n) {
  if (M == 2) return g[0] - g[1] + 1;  // col <= row
  int s = 0;
#pragma unroll
  for (int j = 0; j < M; ++j) s += g[j];
  return n - s;  // sum < n
}

// One warp's tile in type T: blk holds the array-axis block coordinates.
template <int M, typename T>
static __device__ __forceinline__ void accum_tile(T* __restrict__ x, const int* blk, int n,
                                                  int rho, int shift, bool vec) {
  const int lane = threadIdx.x & 31;
  const T one = Dt<T>::from_float(1.f);
  if (!vec) {  // one element a lane, the last axis fastest
    const int tile = simplex_ipow<M>(rho);
    for (int e = lane; e < tile; e += 32) {
      int r = e, g[M];
#pragma unroll
      for (int j = M - 1; j >= 0; --j) g[j] = blk[j] * rho + simplex_split(r, rho, shift);
      if (simplex_in_domain<M>(g, n)) {
        T* p = x + simplex_offset<M>(g, n);
        *p = Dt<T>::add(*p, one);
      }
    }
    return;
  }
  constexpr int EV = 16 / sizeof(T);  // elements a piece
  const int vr = rho / EV;  // pieces a row
  const int pieces = simplex_ipow<M - 1>(rho) * vr;
  for (int base = lane; base < pieces; base += 32 * ACCUM_UNROLL) {
    uint4 v[ACCUM_UNROLL];
    long long off[ACCUM_UNROLL];
    int run[ACCUM_UNROLL];
#pragma unroll
    for (int u = 0; u < ACCUM_UNROLL; ++u) {
      const int e = base + 32 * u;
      run[u] = 0;
      if (e < pieces) {
        int r = e / vr, g[M];
        g[M - 1] = blk[M - 1] * rho + (e - r * vr) * EV;
#pragma unroll
        for (int j = M - 2; j >= 0; --j) g[j] = blk[j] * rho + simplex_split(r, rho, shift);
        run[u] = accum_run<M>(g, n);
        off[u] = simplex_offset<M>(g, n);
        if (run[u] > 0) v[u] = *reinterpret_cast<const uint4*>(x + off[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < ACCUM_UNROLL; ++u) {
      if (run[u] <= 0) continue;  // the piece's first element is off the domain: all are
      T* el = reinterpret_cast<T*>(&v[u]);
#pragma unroll
      for (int i = 0; i < EV; ++i)
        if (i < run[u]) el[i] = Dt<T>::add(el[i], one);
      *reinterpret_cast<uint4*>(x + off[u]) = v[u];
    }
  }
}

// dtype: a code of dtypes.cuh; vec: 16-byte pieces (see the note above).
template <int M>
__global__ void __launch_bounds__(ACCUM_WARPS * 32, ACCUM_BLOCKS)
simplex_accum_kernel(void* __restrict__ x, int dtype, const __grid_constant__ SimplexMap map,
                     int n, int rho, int shift, int vec) {
  const long long step = (long long)blockIdx.x * ACCUM_WARPS + (threadIdx.x >> 5);
  if (step >= map.steps) return;  // the whole warp
  int xs[M];
  int valid = 0;
  if ((threadIdx.x & 31) == 0) valid = simplex_map<M>(map, (int)step, xs);
  if (!__shfl_sync(0xffffffffu, valid, 0)) return;
  int blk[M];  // array-axis order
#pragma unroll
  for (int j = 0; j < M; ++j) blk[j] = __shfl_sync(0xffffffffu, xs[M - 1 - j], 0);
#define SIMPLEX_ACCUM_TILE(T) \
  accum_tile<M, T>(static_cast<T*>(x), blk, n, rho, shift, vec != 0)
  SIMPLEX_SWITCH_DTYPE(dtype, SIMPLEX_ACCUM_TILE)
#undef SIMPLEX_ACCUM_TILE
}

// dtype: a code of dtypes.cuh that ACCUM takes (kernels/policy.py
// DTYPE_CODES); vec: 1 for 16-byte pieces, which needs rho elements of
// the type to be a whole number of pieces and x 16-byte aligned.
extern "C" int simplex_accum_launch(void* x, int dtype, const long long* header,
                                    const void* data, int n, int rho, int vec, void* stream) {
  SimplexMap M;
  if (!simplex_map_unpack(header, data, &M) || rho < 1 || n % rho || !dt_accum_ok(dtype))
    return (int)cudaErrorInvalidValue;
  if (vec && (((uintptr_t)x & 15) || (rho * dt_bytes(dtype)) % 16))
    return (int)cudaErrorInvalidValue;
  if (M.steps == 0) return 0;
  const unsigned blocks = (unsigned)((M.steps + ACCUM_WARPS - 1) / ACCUM_WARPS);
  const int shift = simplex_rho_shift(rho);
  cudaStream_t s = (cudaStream_t)stream;
#define SIMPLEX_ACCUM(MM) \
  simplex_accum_kernel<MM><<<blocks, ACCUM_WARPS * 32, 0, s>>>(x, dtype, M, n, rho, shift, vec)
  SIMPLEX_DISPATCH_M(M.m, SIMPLEX_ACCUM)
#undef SIMPLEX_ACCUM
  return (int)cudaGetLastError();
}
