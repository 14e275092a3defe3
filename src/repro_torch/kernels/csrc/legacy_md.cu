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
// halo are written out here.  The launch index enumerates the
// schedule's steps, as the paper's map does: invalid steps are launched
// too and write nothing.  Array axis j holds x_{m-1-j}: at m = 3 the axes
// are (z, y, x).
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
// cell once, 2 * V * sizeof(T) bytes at 3.35 TB/s; there is one add per
// cell (ACCUM) or 26 (CA, from shared memory).  Element offsets are int64
// (an m=3, n=1024 int32 array is 2^30 elements, 4 GiB).
//
// ACCUM (accum3d, accum_md; one typed tile body, since at m = 3 they
// compute the same thing).  A step's tile at m=3, rho=8, int32 is 2 KiB
// in and 2 KiB out, in 64 rows of 32 bytes 4 KiB apart, so what bounds it
// is how many bytes stay in flight and how few instructions a byte costs.
// A block per step with a thread per element would have every SM retire a
// 4 KiB block each ~160 ns at the bound, evaluate the map in every thread
// and switch on the dtype at every element.  Design:
// - A warp per schedule step, LEGACY_ACCUM_WARPS steps a block.  Lane 0
//   evaluates the map once and broadcasts the block coordinates and the
//   valid flag with __shfl_sync (no shared memory, no barrier); an
//   invalid step's warp returns at once.
// - The dtype is switched once per warp, after the map, into a body typed
//   throughout (SIMPLEX_SWITCH_DTYPE), so each kernel is still compiled
//   once per m, not once per type.
// - 16-byte pieces along the last axis where a tile row of rho elements is
//   a whole number of pieces and the array starts on a 16-byte boundary
//   (the host's fixed rule, kernels/legacy.py legacy_vector_access, passed
//   as `vec`); otherwise one element a lane.  Per piece the run along the
//   last axis, n - (sum of the other coordinates) - first, is computed
//   once, so the element mask is one compare.  A piece whose first element
//   is off the domain is not touched; in a piece on the domain's edge the
//   elements past it are written back unchanged, which is safe because a
//   data block belongs to exactly one step.
// - LEGACY_ACCUM_UNROLL pieces a lane in flight at once, with the L2
//   fetching 128 bytes around each (ld.global.L2::128B): consecutive steps
//   of the map visit neighbouring tiles, whose rows share those bytes.
// - Registers: the map takes most of them; capped at 64 (4 blocks of 8
//   warps an SM) nothing spills and there is no stack frame.  Four pieces
//   a lane, or a cap of 48, spill; on an H100, 16 warps an SM with four
//   pieces (99 registers) and 48 with two (a 40-register cap) were slower.
// - Any rho that divides n: digits of a tile index are shifts and masks
//   where rho is a power of two, divisions elsewhere.
//
// Element types are the reference's: ACCUM and CA run in the array's own
// type (dtypes.cuh holds that arithmetic: integers wrap, 16-bit floats
// round to nearest even after each add).  The type is a run-time code the
// kernel switches on once per step (ACCUM) or after the map (CA's typed
// tile), so each kernel is compiled once, not once per type: the general
// map each inlines is what makes a kernel slow to compile.  CA runs a
// block per step, every thread evaluating the map itself and getting the
// same block coordinates and validity flag, so an invalid step returns in
// every thread at once.
#include <limits.h>
#include <stdint.h>

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
// ACCUM3D and ACCUM_MD: +1 on {sum of coordinates < n} of an (n,)*M
// array, in place.  At M = 3 the two compute the same thing (as the
// reference's two Pallas kernels do), so they share the typed tile body
// and keep their own entries and kernels.
// ---------------------------------------------------------------------------

#define LEGACY_ACCUM_WARPS 8   // schedule steps (warps) a block
#define LEGACY_ACCUM_BLOCKS 4  // blocks an SM: at most 64 registers a thread
#define LEGACY_ACCUM_UNROLL 2  // 16-byte pieces a lane has in flight

// A 16-byte piece read with the L2 fetching the 128 bytes around it: the
// tile rows of the steps that come next along the last axis share them.
static __device__ __forceinline__ uint4 legacy_load_piece(const void* p) {
  uint4 v;
  asm volatile("ld.global.L2::128B.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// Host: log2(rho) when rho is a power of two, else -1 (the kernel divides).
static inline int legacy_pow2_shift(int rho) {
  if (rho < 1 || (rho & (rho - 1))) return -1;
  int s = 0;
  while ((1 << s) < rho) ++s;
  return s;
}

// r -> r / d with the remainder returned: a shift and a mask where d is
// 2^shift (shift >= 0), a division elsewhere.
static __device__ __forceinline__ int legacy_digit(int& r, int d, int shift) {
  const int q = shift >= 0 ? r >> shift : r / d;
  const int rem = r - q * d;
  r = q;
  return rem;
}

// One warp's tile in type T from its array-axis origin org (elements).
// Vector path: piece e is row e / vr of the tile (the rows' coordinates
// are the digits of the row index in base rho, the second-to-last axis
// fastest) and piece e % vr of that row, so a warp covers whole rows and
// neighbouring lanes touch neighbouring 16-byte pieces.
template <int M, typename T>
static __device__ __forceinline__ void legacy_accum_tile(T* __restrict__ x, const int* org,
                                                         int n, int rho, int shift, bool vec) {
  const int lane = threadIdx.x & 31;
  const T one = Dt<T>::from_float(1.f);
  int rows = 1;  // rho^(M-1) rows of rho elements along the last axis
#pragma unroll
  for (int j = 0; j < M - 1; ++j) rows *= rho;
  if (!vec) {  // one element a lane, the last axis fastest
    for (int e = lane; e < rows * rho; e += 32) {
      int r = e, sum = 0;
      long long off = 0, scale = 1;
#pragma unroll
      for (int j = M - 1; j >= 0; --j) {
        const int g = org[j] + legacy_digit(r, rho, shift);
        sum += g;
        off += g * scale;
        scale *= n;
      }
      if (sum < n) x[off] = Dt<T>::add(x[off], one);
    }
    return;
  }
  constexpr int EV = 16 / sizeof(T);  // elements a piece
  constexpr int EV_SHIFT = EV == 16 ? 4 : EV == 8 ? 3 : EV == 4 ? 2 : 1;
  const int vr = rho / EV;  // pieces a row
  const int vshift = shift >= 0 ? shift - EV_SHIFT : -1;
  const int pieces = rows * vr;
  for (int base = lane; base < pieces; base += 32 * LEGACY_ACCUM_UNROLL) {
    uint4 v[LEGACY_ACCUM_UNROLL];
    T* p[LEGACY_ACCUM_UNROLL];
    int run[LEGACY_ACCUM_UNROLL];
#pragma unroll
    for (int u = 0; u < LEGACY_ACCUM_UNROLL; ++u) {
      const int e = base + 32 * u;
      run[u] = 0;
      if (e < pieces) {
        int r = e;
        const int first = org[M - 1] + legacy_digit(r, vr, vshift) * EV;
        int sum = first;
        long long off = first, scale = n;
#pragma unroll
        for (int j = M - 2; j >= 0; --j) {
          const int g = org[j] + legacy_digit(r, rho, shift);
          sum += g;
          off += g * scale;
          scale *= n;
        }
        run[u] = n - sum;  // the row's elements from `first` on the domain
        p[u] = x + off;
        if (run[u] > 0) v[u] = legacy_load_piece(p[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < LEGACY_ACCUM_UNROLL; ++u) {
      if (run[u] <= 0) continue;  // the piece's first element is off the domain: all are
      T* el = reinterpret_cast<T*>(&v[u]);
#pragma unroll
      for (int i = 0; i < EV; ++i)
        if (i < run[u]) el[i] = Dt<T>::add(el[i], one);
      *reinterpret_cast<uint4*>(p[u]) = v[u];
    }
  }
}

// One warp per schedule step: lane 0 evaluates the map, the block
// coordinates and the valid flag reach the other lanes by __shfl_sync, an
// invalid step's warp returns, and the dtype is switched once into the
// typed tile body.
template <int M>
static __device__ __forceinline__ void legacy_accum_step(void* __restrict__ x, int dtype,
                                                         const SimplexMap& map, int n, int rho,
                                                         int shift, int vec) {
  const long long step = (long long)blockIdx.x * LEGACY_ACCUM_WARPS + (threadIdx.x >> 5);
  if (step >= map.steps) return;  // the whole warp
  int c[M];
  int valid = 0;
  if ((threadIdx.x & 31) == 0) valid = simplex_map<M>(map, (int)step, c);
  if (!__shfl_sync(0xffffffffu, valid, 0)) return;
  int org[M];  // per array axis; axis j holds x_{M-1-j}
#pragma unroll
  for (int j = 0; j < M; ++j) org[j] = __shfl_sync(0xffffffffu, c[M - 1 - j], 0) * rho;
#define LEGACY_ACCUM_TILE(T) \
  legacy_accum_tile<M, T>(static_cast<T*>(x), org, n, rho, shift, vec != 0)
  SIMPLEX_SWITCH_DTYPE(dtype, LEGACY_ACCUM_TILE)
#undef LEGACY_ACCUM_TILE
}

__global__ void __launch_bounds__(LEGACY_ACCUM_WARPS * 32, LEGACY_ACCUM_BLOCKS)
legacy_accum3d_kernel(void* __restrict__ x, int dtype, const __grid_constant__ SimplexMap map,
                      int n, int rho, int shift, int vec) {
  legacy_accum_step<3>(x, dtype, map, n, rho, shift, vec);
}

template <int M>
__global__ void __launch_bounds__(LEGACY_ACCUM_WARPS * 32, LEGACY_ACCUM_BLOCKS)
legacy_accum_md_kernel(void* __restrict__ x, int dtype, const __grid_constant__ SimplexMap map,
                       int n, int rho, int shift, int vec) {
  legacy_accum_step<M>(x, dtype, map, n, rho, shift, vec);
}

// Host: the launch's checks (m 0 for any m >= 3; vec needs rho elements
// of the type to be a whole number of 16-byte pieces and x on a 16-byte
// boundary) and its grid of LEGACY_ACCUM_WARPS steps a block.
static bool legacy_accum_setup(const void* x, int dtype, const long long* header,
                               const void* data, int m, int n, int rho, int vec,
                               SimplexMap* map, unsigned* blocks) {
  int threads;
  if (!legacy_md_setup(header, data, m, n, rho, map, &threads) || !dt_accum_ok(dtype))
    return false;
  if (vec && (((uintptr_t)x & 15) || (rho * dt_bytes(dtype)) % 16)) return false;
  *blocks = (unsigned)((map->steps + LEGACY_ACCUM_WARPS - 1) / LEGACY_ACCUM_WARPS);
  return true;
}

// dtype: a code of dtypes.cuh that ACCUM takes (kernels/policy.py
// DTYPE_CODES); vec: 1 for 16-byte pieces (kernels/legacy.py
// legacy_vector_access), 0 for single elements.
extern "C" int legacy_accum3d_launch(void* x, int dtype, const long long* header,
                                     const void* data, int n, int rho, int vec, void* stream) {
  SimplexMap map;
  unsigned blocks;
  if (!legacy_accum_setup(x, dtype, header, data, 3, n, rho, vec, &map, &blocks))
    return (int)cudaErrorInvalidValue;
  if (map.steps == 0) return 0;
  legacy_accum3d_kernel<<<blocks, LEGACY_ACCUM_WARPS * 32, 0, (cudaStream_t)stream>>>(
      x, dtype, map, n, rho, legacy_pow2_shift(rho), vec);
  return (int)cudaGetLastError();
}

// m comes from the header (3..SIMPLEX_MAX_M); dtype and vec as for accum3d.
extern "C" int legacy_accum_md_launch(void* x, int dtype, const long long* header,
                                      const void* data, int n, int rho, int vec, void* stream) {
  SimplexMap map;
  unsigned blocks;
  if (!legacy_accum_setup(x, dtype, header, data, 0, n, rho, vec, &map, &blocks))
    return (int)cudaErrorInvalidValue;
  if (map.steps == 0) return 0;
  const int shift = legacy_pow2_shift(rho);
  cudaStream_t s = (cudaStream_t)stream;
#define LEGACY_ACCUM_MD(MM)                                                        \
  legacy_accum_md_kernel<MM><<<blocks, LEGACY_ACCUM_WARPS * 32, 0, s>>>(x, dtype, map, n, \
                                                                        rho, shift, vec)
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
