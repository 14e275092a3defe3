// The frozen m >= 3 originals: ACCUM on the 3-simplex T(n) of an
// (n, n, n) array, ACCUM on the m-simplex of an (n,)*m array, and one
// 26-neighbour CA step on T(n), each over a linear grid of schedule steps.
//
// Replaces: the TPU kernels of repro/kernels/legacy.py accum3d, ca3d and
// accum_md (kernel table rows 11-13).  They are the independent
// differential baseline of the engine kernels at m >= 3 (accum.cu,
// ca.cu), so they share nothing with them beyond the schedule subsystem:
// the SimplexMap, its host unpacking and simplex_map, which the
// reference's legacy kernels call too (its sched.map).  No
// simplex_in_domain, simplex_offset, simplex_split, simplex_ipow,
// stencil table or engine entry: the domain test, the offsets and the
// halo are written out here.  Block blockIdx.x is step
// blockIdx.x of the schedule; every thread evaluates the map itself and
// gets the same math-order block coordinates (x_0, ..., x_{m-1}) and
// validity flag, so an invalid step returns in every thread at once.
// Array axis j holds x_{m-1-j}: at m = 3 the axes are (z, y, x).
//
// On the TPU invalid steps parked on a trash tile appended along axis 0
// and the input was aliased to the output; here an invalid step writes
// nothing.  ACCUM updates the buffer it is given (the wrapper passes a
// copy, and a split composite launches once per piece on that copy); CA
// reads one buffer and writes another that starts as a copy of the
// input, because blocks run in no order.  CA stages a (rho+2)^3 halo in
// shared memory, each cell masked by its true coordinate: a neighbour
// counts only inside [0, n)^3 and inside the tetrahedron.  The
// reference's 27 clamped (rho,)^3 tiles and (3rho)^3 scratch are how a
// TPU gets a halo and are not carried over.
//
// Bound on the card: memory.  ACCUM and CA read and write each domain
// cell once, 2 * V * sizeof(T) bytes; there is one add per cell (ACCUM)
// or 26 (CA, from shared memory).  Design: one block per step, rho^m
// elements per tile with the last array axis fastest so neighbouring
// threads touch neighbouring addresses, a loop when rho^m exceeds the
// block's 1024 threads.  Element offsets are int64 (an m=3, n=1024 int32
// array is 2^30 elements, 4 GiB).
//
// Element types are the reference's: ACCUM and CA run in the array's own
// type (dtypes.cuh holds that arithmetic: integers wrap, 16-bit floats
// round to nearest even after each add).  The type is a run-time code the
// kernel switches on at the element (ACCUM) or after the map (CA's
// typed tile), so each kernel is compiled once, not once per type: every
// thread here inlines the general map, which is what makes a kernel slow
// to compile.
#include <limits.h>

#include "dtypes.cuh"
#include "simplex_maps.cuh"

// Host: unpack the schedule and check the launch: m (0 for any m >= 3)
// and the operand's side n = nb * rho.  Sets the threads per block.
static bool legacy_md_setup(const long long* header, const void* data, int m, int n,
                            int rho, SimplexMap* map, int* threads) {
  if (!simplex_map_unpack(header, data, map) || map->m < 3 || (m && map->m != m) || rho < 1 ||
      (long long)map->n * rho != n)
    return false;
  long long tile = 1;
  for (int j = 0; j < map->m; ++j) tile *= rho;
  if (tile > INT_MAX) return false;
  *threads = tile < 1024 ? (int)tile : 1024;
  return true;
}

// ---------------------------------------------------------------------------
// ACCUM3D: +1 on T(n) = {x + y + z < n} of an (n, n, n) array, in place.
// ---------------------------------------------------------------------------

__global__ void legacy_accum3d_kernel(void* __restrict__ x, int dtype,
                                      const __grid_constant__ SimplexMap map, int n, int rho) {
  int c[3];
  if (!simplex_map<3>(map, (int)blockIdx.x, c)) return;
  const int z0 = c[2] * rho, y0 = c[1] * rho, x0 = c[0] * rho;
  const int rr = rho * rho;
  for (int e = threadIdx.x; e < rr * rho; e += blockDim.x) {
    const int i = e / rr;
    const int r = e - i * rr;
    const int j = r / rho;
    const int gz = z0 + i, gy = y0 + j, gx = x0 + (r - j * rho);
    if (gx + gy + gz < n) dt_add_one(x, ((long long)gz * n + gy) * n + gx, dtype);
  }
}

// dtype: a code of dtypes.cuh that ACCUM takes (kernels/policy.py DTYPE_CODES).
extern "C" int legacy_accum3d_launch(void* x, int dtype, const long long* header,
                                     const void* data, int n, int rho, void* stream) {
  SimplexMap map;
  int threads;
  if (!legacy_md_setup(header, data, 3, n, rho, &map, &threads) ||
      !dt_accum_ok(dtype))
    return (int)cudaErrorInvalidValue;
  if (map.steps == 0) return 0;
  legacy_accum3d_kernel<<<map.steps, threads, 0, (cudaStream_t)stream>>>(x, dtype, map, n, rho);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// ACCUM_MD: +1 on {sum of coordinates < n} of an (n,)*M array, in place.
// ---------------------------------------------------------------------------

template <int M>
__global__ void legacy_accum_md_kernel(void* __restrict__ x, int dtype,
                                       const __grid_constant__ SimplexMap map, int n, int rho,
                                       int tile) {
  int c[M];
  if (!simplex_map<M>(map, (int)blockIdx.x, c)) return;
  int origin[M];  // per array axis; axis j holds x_{M-1-j}
#pragma unroll
  for (int j = 0; j < M; ++j) origin[j] = c[M - 1 - j] * rho;
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    int g[M];
    int r = e, sum = 0;
#pragma unroll
    for (int j = M - 1; j >= 0; --j) {  // the last axis fastest
      const int q = r / rho;
      g[j] = origin[j] + (r - q * rho);
      r = q;
      sum += g[j];
    }
    if (sum < n) {
      long long off = 0;
#pragma unroll
      for (int j = 0; j < M; ++j) off = off * n + g[j];
      dt_add_one(x, off, dtype);
    }
  }
}

// m comes from the header (3..SIMPLEX_MAX_M); dtype as for accum3d.
extern "C" int legacy_accum_md_launch(void* x, int dtype, const long long* header,
                                      const void* data, int n, int rho, void* stream) {
  SimplexMap map;
  int threads;
  if (!legacy_md_setup(header, data, 0, n, rho, &map, &threads) ||
      !dt_accum_ok(dtype))
    return (int)cudaErrorInvalidValue;
  if (map.steps == 0) return 0;
  int tile = 1;
  for (int j = 0; j < map.m; ++j) tile *= rho;
  cudaStream_t s = (cudaStream_t)stream;
#define LEGACY_ACCUM_MD(MM) \
  legacy_accum_md_kernel<MM><<<map.steps, threads, 0, s>>>(x, dtype, map, n, rho, tile)
  SIMPLEX_DISPATCH_M(map.m, LEGACY_ACCUM_MD)
#undef LEGACY_ACCUM_MD
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// CA3D: one B3/S23 step over 26 neighbours on T(n), free boundaries, in -> out.
// ---------------------------------------------------------------------------

// One tile in the state's type T from the block's origin (z0, y0, x0).
template <typename T>
static __device__ __forceinline__ void legacy_ca3d_tile(T* __restrict__ out,
                                                        const T* __restrict__ in, int z0,
                                                        int y0, int x0, int n, int rho,
                                                        unsigned char* smem) {
  T* s_halo = reinterpret_cast<T*>(smem);  // (rho+2)^3, origin one cell before the tile
  const T zero = Dt<T>::from_float(0.f);
  const int hs = rho + 2, hh = hs * hs;
  for (int e = threadIdx.x; e < hh * hs; e += blockDim.x) {
    const int i = e / hh;
    const int r = e - i * hh;
    const int j = r / hs;
    const int gz = z0 + i - 1, gy = y0 + j - 1, gx = x0 + (r - j * hs) - 1;
    const bool ok = gz >= 0 && gy >= 0 && gx >= 0 && gz < n && gy < n && gx < n &&
                    gx + gy + gz < n;  // off the cube or the tetrahedron: dead
    s_halo[e] = ok ? in[((long long)gz * n + gy) * n + gx] : zero;
  }
  __syncthreads();
  const int rr = rho * rho;
  for (int e = threadIdx.x; e < rr * rho; e += blockDim.x) {
    const int i = e / rr;
    const int r = e - i * rr;
    const int j = r / rho;
    const int k = r - j * rho;
    const int gz = z0 + i, gy = y0 + j, gx = x0 + k;
    if (gx + gy + gz >= n) continue;  // off the domain: keeps its input
    const T* q = s_halo + ((i + 1) * hs + (j + 1)) * hs + (k + 1);
    // the reference's order over the 27 offsets, the centre left out, in
    // the state's own type
    T neigh = zero;
    for (int dz = -1; dz <= 1; ++dz)
      for (int dy = -1; dy <= 1; ++dy)
        for (int dx = -1; dx <= 1; ++dx)
          if (dz || dy || dx) neigh = Dt<T>::add(neigh, q[(dz * hs + dy) * hs + dx]);
    const T centre = q[0];
    const bool three = Dt<T>::eq(neigh, 3);
    const bool alive = (Dt<T>::eq(centre, 0) && three) ||
                       (Dt<T>::eq(centre, 1) && (Dt<T>::eq(neigh, 2) || three));
    out[((long long)gz * n + gy) * n + gx] = Dt<T>::from_float(alive ? 1.f : 0.f);
  }
}

__global__ void legacy_ca3d_kernel(void* __restrict__ out, const void* __restrict__ in,
                                   int dtype, const __grid_constant__ SimplexMap map, int n,
                                   int rho) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  int c[3];
  if (!simplex_map<3>(map, (int)blockIdx.x, c)) return;  // uniform in the block
  const int z0 = c[2] * rho, y0 = c[1] * rho, x0 = c[0] * rho;
#define LEGACY_CA3D_TILE(T) \
  legacy_ca3d_tile<T>(static_cast<T*>(out), static_cast<const T*>(in), z0, y0, x0, n, rho, s_raw)
  SIMPLEX_SWITCH_CA_DTYPE(dtype, LEGACY_CA3D_TILE)
#undef LEGACY_CA3D_TILE
}

// dtype: a code of dtypes.cuh that CA takes (kernels/policy.py DTYPE_CODES).
extern "C" int legacy_ca3d_launch(void* out, const void* in, int dtype,
                                  const long long* header, const void* data, int n, int rho,
                                  void* stream) {
  SimplexMap map;
  int threads;
  if (!legacy_md_setup(header, data, 3, n, rho, &map, &threads) || !dt_ca_ok(dtype))
    return (int)cudaErrorInvalidValue;
  if (map.steps == 0) return 0;
  const size_t smem =
      (size_t)dt_bytes(dtype) * (size_t)(rho + 2) * (rho + 2) * (rho + 2);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        legacy_ca3d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  legacy_ca3d_kernel<<<map.steps, threads, smem, (cudaStream_t)stream>>>(out, in, dtype, map,
                                                                         n, rho);
  return (int)cudaGetLastError();
}
