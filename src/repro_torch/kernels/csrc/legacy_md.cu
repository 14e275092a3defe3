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
// round to nearest even after each add).  The type is a run-time code each
// kernel switches on once per step, after the map, so each kernel is
// compiled once, not once per type: the general map each inlines is what
// makes a kernel slow to compile.
//
// CA3D (ca3d).  A step's tile at rho=8, int32 is 512 cells whose 26-cell
// counts read a (rho+2)^3 halo of 1000.  A block per step with a thread
// per cell had every thread evaluate the map (2,097,152 blocks of 512
// threads at bb), stage the halo cell by cell with two divisions and a
// scalar load each, and read 27 cells of shared memory per cell.  With a
// warp per step and a halo a warp, staging took most of the time (the L2
// serving three 32-byte sectors for each 40-byte halo row; that variant
// runs 1.3-1.4x this kernel's time in scripts/legacy_variants.py), so a
// block shares one halo where it can.  Design:
// - A warp per schedule step, LEGACY_CA_WARPS a block (fewer where the
//   shared halo would pass LEGACY_CA_BUDGET, e.g. at rho=16).  Lane 0 of
//   each warp evaluates the map once and puts the valid flag and the tile
//   origin in the block's table; after one barrier every thread reads
//   whether the block's tiles lie side by side along x (92 % of hmap's
//   valid steps at n=1024: the recursion walks x fastest inside cubes of
//   8 tiles and more).  A block with no valid step returns whole.  The
//   dtype is switched once, after the map, into a body typed throughout.
// - Shared: the block's threads stage one halo of (rho+2)^2 rows along x,
//   each a lead piece, the warps' tiles' rows (warps * rho cells) and a
//   trail piece, then each warp counts its tile from it: a halo row of
//   the block costs about 10 sectors where eight warps' own rows cost 24.
//   Otherwise each warp with a valid step stages its own one-tile halo in
//   one of `slots` slices of the same memory, `slots` warps a round.
// - Staging: a halo row's parts go to consecutive threads, PE cells each:
//   16-byte pieces where the host's fixed rule says so
//   (kernels/legacy.py CA3DKernel.vector_access: rho cells are whole
//   pieces, both buffers start on a 16-byte boundary and a slice fits), so
//   the left edge cell is the lead's last and the right edge the trail's
//   first; elsewhere PE = 1, every cell a scalar.  A thread's row and part
//   advance without a division, and a row's mask is one run, lim = n - gz
//   - gy inside [0, n)^2 (0 outside): a piece starting at xs keeps its
//   first lim - xs cells and the rest are zero.  16-byte pieces go by
//   cp.async with that many bytes read and the rest zero-filled, all of a
//   thread's in flight at once, no register held; scalars by load and
//   store.  A row's stride is padded by two pieces where it would be a
//   multiple of four pieces, so that a quarter warp's loads of the tile's
//   rows fall on distinct banks.
// - The count walks z.  A lane takes XW cells of a tile row (a 16-, 8- or
//   4-byte load: 4 cells of a type up to 4 bytes, 2 of int64; 1 on the
//   scalar path) over a segment of zs planes (the host's rule: as few
//   segments as keep the warp's lanes busy, zs = rho / 2 at rho=8 in
//   int32), and keeps the plane sums of the planes before, at and after
//   its cell in registers: each new plane costs three row reads, the
//   row's own cells in one load and the two beside them from the
//   neighbouring lanes by __shfl_up/down_sync, or from shared memory for
//   the first and last lane of a row.  About 3 (XW + 2) / XW cells read a
//   cell and plane, (zs + 2) / zs planes a cell, not 27.
//   The count's order: R = (h[x-1] + h[x]) + h[x+1] along x, P = (R[y-1] +
//   R[y]) + R[y+1] along y, count = ((P[z-1] + P[z]) + P[z+1]) - centre,
//   in an unsigned integer of at least 32 bits for integer states (it
//   wraps as the state's type does once cut back to it, so the count is
//   bit-equal to the plain version's -centre + sum of 27 at any values)
//   and in float32 for floating states (bit-equal wherever every partial
//   sum is exact in float32 and in the state's type: always for 0/1
//   states, whose count is at most 27; not for states of other values,
//   where the plain version rounds each add in the state's type).
// - Stores: a lane's XW cells go out as one 16-, 8- or 4-byte store where
//   they all lie on the domain, else cell by cell on the domain; cells off
//   it keep their input (the output starts as a copy).
// - Any rho that divides n: the tile's digits are shifts where rho is a
//   power of two, divisions elsewhere, once per lane and segment.
// - Registers: two instantiations, so that no type's body spills: WIDE =
//   0 (8-, 16- and 32-bit integers, float32) capped at 64 registers
//   (LEGACY_CA_BLOCKS blocks of 8 warps an SM), WIDE = 1 (int64's 64-bit
//   counts, bfloat16 and float16 widened) at 85 (LEGACY_CA_BLOCKS_WIDE);
//   one kernel for all eight types spilled at 64 and ran slower at 85
//   (three blocks an SM).  Each inlines the map once.
#include <limits.h>
#include <stdint.h>

#include "dtypes.cuh"
#include "simplex_maps.cuh"

// Host: unpack the schedule and check the launch: m (0 for any m >= 3)
// and the operand's side n = nb * rho.
static bool legacy_md_setup(const long long* header, const void* data, int m, int n,
                            int rho, SimplexMap* map) {
  if (!simplex_map_unpack(header, data, map) || map->m < 3 || (m && map->m != m) || rho < 1 ||
      (long long)map->n * rho != n)
    return false;
  long long tile = 1;
  for (int j = 0; j < map->m; ++j) tile *= rho;
  return tile <= INT_MAX;
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
  if (!legacy_md_setup(header, data, m, n, rho, map) || !dt_accum_ok(dtype))
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

#define LEGACY_CA_WARPS 8             // schedule steps (warps) a block, at most
#define LEGACY_CA_BLOCKS 4            // blocks an SM: at most 64 registers a thread
#define LEGACY_CA_BLOCKS_WIDE 3       // for the wide counts: at most 85
#define LEGACY_CA_BUDGET (56 * 1024)  // a shared halo's bytes, at most (four blocks an SM)
#define LEGACY_BLOCK_SMEM 232448      // a block's shared memory, bytes
#define LEGACY_FULL 0xffffffffu

// The neighbour count's type A for states of type T: integers add in an
// unsigned type of at least 32 bits (a count cut back to T wraps as T's
// own adds do), floating states in float32.
template <typename T>
struct LegacyCount;
#define LEGACY_COUNT_INT(T, U, AA)                                                            \
  template <>                                                                                 \
  struct LegacyCount<T> {                                                                     \
    using A = AA;                                                                             \
    static __device__ __forceinline__ A widen(T v) { return (A)(U)v; }                        \
    static __device__ __forceinline__ bool is(A a, int v) { return (U)a == (U)(T)v; }         \
  };
LEGACY_COUNT_INT(int8_t, uint8_t, uint32_t)
LEGACY_COUNT_INT(uint8_t, uint8_t, uint32_t)
LEGACY_COUNT_INT(int16_t, uint16_t, uint32_t)
LEGACY_COUNT_INT(int32_t, uint32_t, uint32_t)
LEGACY_COUNT_INT(long long, unsigned long long, unsigned long long)
#undef LEGACY_COUNT_INT
#define LEGACY_COUNT_FLOAT(T, WIDEN)                                                          \
  template <>                                                                                 \
  struct LegacyCount<T> {                                                                     \
    using A = float;                                                                          \
    static __device__ __forceinline__ A widen(T v) { return WIDEN(v); }                       \
    static __device__ __forceinline__ bool is(A a, int v) { return a == (float)v; }           \
  };
LEGACY_COUNT_FLOAT(float, (float))
LEGACY_COUNT_FLOAT(__nv_bfloat16, __bfloat162float)
LEGACY_COUNT_FLOAT(__half, __half2float)
#undef LEGACY_COUNT_FLOAT

// XW cells of T read or written as one access.
template <typename T, int XW>
struct alignas(XW * sizeof(T)) LegacyCells {
  T v[XW];
};

// One 16-byte piece into shared memory by cp.async: `bytes` of it read
// from src, the rest zero-filled (src may then be any valid address).
static __device__ __forceinline__ void legacy_copy_piece(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}

// The (rho+2)^3 halo of `tiles` tiles side by side along x from the
// origin (z0, y0, x0), by thread t of nt: halo row hr = hz * (rho+2) + hy
// at hr * rs holds the cells x0 - PE .. x0 + tiles * rho + PE - 1 of
// array row (z0 + hz - 1, y0 + hy - 1), each live cell as it is and every
// other cell 0.  A row's parts (lead piece, tiles * rho / PE pieces,
// trail piece) go to consecutive threads, nt parts at once; a thread's
// row and part advance by nt parts without a division.
template <typename T, int PE>
static __device__ __forceinline__ void legacy_ca3d_stage(T* halo, const T* __restrict__ in,
                                                         int z0, int y0, int x0, int n,
                                                         int rho, int tiles, int rs, int t,
                                                         int nt) {
  const int H = rho + 2, parts = tiles * rho / PE + 2;
  const int dr = nt / parts, dp = nt - dr * parts;
  int hr = t / parts, p = t - hr * parts;
  int hz = 0, hy = hr;
  while (hy >= H) hy -= H, ++hz;
  while (hr < H * H) {
    const int gz = z0 + hz - 1, gy = y0 + hy - 1;
    const int lim = gz >= 0 && gz < n && gy >= 0 && gy < n ? n - gz - gy : 0;
    const int xs = x0 + (p - 1) * PE;  // the part's first cell
    int cnt = xs < 0 ? 0 : lim - xs;   // its live cells
    cnt = cnt < 0 ? 0 : (cnt > PE ? PE : cnt);
    const T* src = in + ((long long)min(max(gz, 0), n - 1) * n + min(max(gy, 0), n - 1)) * n;
    T* dst = halo + hr * rs + p * PE;
    if constexpr (PE > 1)
      legacy_copy_piece(dst, cnt ? src + xs : in, cnt * (int)sizeof(T));
    else
      *dst = cnt ? src[xs] : Dt<T>::from_float(0.f);
    p += dp;
    hr += dr;
    hy += dr;
    if (p >= parts) p -= parts, ++hr, ++hy;
    while (hy >= H) hy -= H, ++hz;
  }
}

// One halo row's sums along x at a lane's XW cells p[0..XW-1]: R[i] =
// (h[i-1] + h[i]) + h[i+1] in the count's type.  The cell left of the
// first comes from the lane before (the last of its cells), or from
// shared memory where `lsm` (the first lane of a row); the cell right of
// the last likewise from the lane after, or from shared memory where
// `rsm`.  Every lane of the warp calls it together.
template <typename T, int XW>
static __device__ __forceinline__ void legacy_ca3d_row(const T* p, bool lsm, bool rsm,
                                                       typename LegacyCount<T>::A (&r)[XW],
                                                       T (&cells)[XW]) {
  using C = LegacyCount<T>;
  using A = typename C::A;
  const LegacyCells<T, XW> v = *reinterpret_cast<const LegacyCells<T, XW>*>(p);
  A h[XW];
#pragma unroll
  for (int i = 0; i < XW; ++i) {
    cells[i] = v.v[i];
    h[i] = C::widen(v.v[i]);
  }
  const A up = __shfl_up_sync(LEGACY_FULL, h[XW - 1], 1);
  const A down = __shfl_down_sync(LEGACY_FULL, h[0], 1);
  const A left = lsm ? C::widen(p[-1]) : up;
  const A right = rsm ? C::widen(p[XW]) : down;
#pragma unroll
  for (int i = 0; i < XW; ++i)
    r[i] = ((i == 0 ? left : h[i - 1]) + h[i]) + (i == XW - 1 ? right : h[i + 1]);
}

// The sums over a halo plane's rows y-1, y, y+1 (p at the first of them):
// P[i] = (R[y-1] + R[y]) + R[y+1]; `cells` gets row y's own cells.
template <typename T, int XW>
static __device__ __forceinline__ void legacy_ca3d_plane(const T* p, int rs, bool lsm, bool rsm,
                                                         typename LegacyCount<T>::A (&s)[XW],
                                                         T (&cells)[XW]) {
  using A = typename LegacyCount<T>::A;
  A r0[XW], r1[XW], r2[XW];
  T c0[XW], c2[XW];
  legacy_ca3d_row<T, XW>(p, lsm, rsm, r0, c0);
  legacy_ca3d_row<T, XW>(p + rs, lsm, rsm, r1, cells);
  legacy_ca3d_row<T, XW>(p + 2 * rs, lsm, rsm, r2, c2);
#pragma unroll
  for (int i = 0; i < XW; ++i) s[i] = (r0[i] + r1[i]) + r2[i];
}

// The count and the rule over one warp's tile.  Work item it = (segment
// seg, tile row y, chunk c of its pieces), the chunk fastest: a lane
// group of lr lanes takes the pieces xp = c * lr + li of tile row y and
// walks z over seg * zs .. (seg + 1) * zs - 1.  Items go to the lane
// groups in turns; lanes without one still take part in the shuffles.
template <typename T, int PE, int XW>
static __device__ __forceinline__ void legacy_ca3d_count(T* __restrict__ out, const T* halo,
                                                         int z0, int y0, int x0, int n, int rho,
                                                         int shift, int rs, int zs) {
  using C = LegacyCount<T>;
  using A = typename C::A;
  const int lane = threadIdx.x & 31;
  const int ps = (rho + 2) * rs;  // halo plane stride
  const int vr = rho / XW;        // pieces a tile row
  const int lr = vr < 32 ? vr : 32, groups = 32 / lr;
  const int gi = lane / lr, li = lane - gi * lr;
  const int chunks = (vr + 31) / 32;
  const int items = rho * (rho / zs) * chunks;
  const T zero = Dt<T>::from_float(0.f), one = Dt<T>::from_float(1.f);
  for (int base = 0; base < items; base += groups) {
    int r = base + gi;
    bool act = gi < groups && r < items;
    if (!act) r = 0;
    const int c = r % chunks;
    r /= chunks;
    const int y = legacy_digit(r, rho, shift), seg = r;
    int xp = c * lr + li;
    act = act && xp < vr;
    if (!act) xp = 0;
    const bool lsm = li == 0, rsm = li == lr - 1 || xp == vr - 1;
    const int zb = seg * zs;
    // halo plane h holds tile plane h - 1; halo row y holds tile row y - 1
    const T* col = halo + (zb * (rho + 2) + y) * rs + PE + xp * XW;
    A below[XW], at[XW], above[XW];
    T cen[XW], next[XW];
    legacy_ca3d_plane<T, XW>(col, rs, lsm, rsm, below, cen);
    legacy_ca3d_plane<T, XW>(col + ps, rs, lsm, rsm, at, cen);
    const int gx = x0 + xp * XW;
    for (int z = zb; z < zb + zs; ++z) {
      legacy_ca3d_plane<T, XW>(col + (z - zb + 2) * ps, rs, lsm, rsm, above, next);
      const int gz = z0 + z, gy = y0 + y;
      const int run = n - gz - gy - gx;  // cells on the domain from gx on
      if (act && run > 0) {
        LegacyCells<T, XW> res;
#pragma unroll
        for (int i = 0; i < XW; ++i) {
          const A neigh = ((below[i] + at[i]) + above[i]) - C::widen(cen[i]);
          const bool three = C::is(neigh, 3);
          const bool alive = (Dt<T>::eq(cen[i], 0) && three) ||
                             (Dt<T>::eq(cen[i], 1) && (C::is(neigh, 2) || three));
          res.v[i] = alive ? one : zero;
        }
        T* dst = out + ((long long)gz * n + gy) * n + gx;
        if (run >= XW) {
          *reinterpret_cast<LegacyCells<T, XW>*>(dst) = res;
        } else {
#pragma unroll
          for (int i = 0; i < XW; ++i)
            if (i < run) dst[i] = res.v[i];
        }
      }
#pragma unroll
      for (int i = 0; i < XW; ++i) {
        below[i] = at[i];
        at[i] = above[i];
        cen[i] = next[i];
      }
    }
  }
}

// The block's tiles in the state's type.  Shared: the warps' tiles lie
// side by side along x, so the block stages one halo (rows of its warps *
// rho cells and a lead and trail piece) and each warp counts its tile
// from it.  Otherwise each warp with a valid step stages its own halo in
// one of `slots` slices of the same shared memory and counts it, `slots`
// warps a round.  Vector path: 16-byte staging pieces and XW = 4 cells a
// lane (2 for int64); scalar path: single cells.
template <typename T, int PE, int XW>
static __device__ __forceinline__ void legacy_ca3d_tile(T* __restrict__ out,
                                                        const T* __restrict__ in, T* halo,
                                                        const int* org, bool shared, int n,
                                                        int rho, int shift, int rs, int rs1,
                                                        int zs, int slice, int slots) {
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int* o = org + 4 * warp;  // this warp's tile: valid, z0, y0, x0
  const int rounds = shared ? 1 : (warps + slots - 1) / slots;
  for (int round = 0; round < rounds; ++round) {
    const int at = warp - round * slots;  // the warp's slice in this round
    const bool mine = shared || (at >= 0 && at < slots && o[0]);
    T* mem = shared ? halo : halo + at * slice;
    const int* from = shared ? org : o;  // the halo's first tile
    if (shared || mine)
      legacy_ca3d_stage<T, PE>(mem, in, from[1], from[2], from[3], n, rho, shared ? warps : 1,
                               shared ? rs : rs1, shared ? threadIdx.x : threadIdx.x & 31,
                               shared ? blockDim.x : 32);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (shared)
      __syncthreads();
    else
      __syncwarp();
    if (mine)
      legacy_ca3d_count<T, PE, XW>(out, shared ? halo + warp * rho : mem, o[1], o[2], o[3], n,
                                   rho, shift, shared ? rs : rs1, zs);
    if (!shared) __syncthreads();  // the slices are free again
  }
}

// One warp per schedule step: lane 0 evaluates the map and puts the valid
// flag and the tile origin in shared memory; after a barrier every thread
// reads whether the block's tiles lie side by side along x (a block with
// no valid step returns whole), and the dtype is switched once into the
// typed tile.  Warps are never sent home before the block's last barrier.
// WIDE = 1 serves the states whose count takes more registers (int64's
// 64-bit sums, bfloat16 and float16 widened to float32) under a cap of
// LEGACY_CA_BLOCKS_WIDE blocks an SM; WIDE = 0 the others under
// LEGACY_CA_BLOCKS: each type's body then fits its cap without a spill.
template <int WIDE>
__global__ void __launch_bounds__(LEGACY_CA_WARPS * 32,
                                  WIDE ? LEGACY_CA_BLOCKS_WIDE : LEGACY_CA_BLOCKS)
legacy_ca3d_kernel(void* __restrict__ out, const void* __restrict__ in, int dtype,
                   const __grid_constant__ SimplexMap map, int n, int rho, int shift, int vec,
                   int rs, int rs1, int zs, int slice, int slots) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  int* org = reinterpret_cast<int*>(s_raw);  // [warps][4]: valid, z0, y0, x0
  unsigned char* halo = s_raw + 16 * LEGACY_CA_WARPS;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const long long step = (long long)blockIdx.x * warps + warp;
  if ((threadIdx.x & 31) == 0) {
    int c[3] = {0, 0, 0};
    const int valid = step < map.steps && simplex_map<3>(map, (int)step, c);
    org[4 * warp] = valid;
    org[4 * warp + 1] = c[2] * rho;
    org[4 * warp + 2] = c[1] * rho;
    org[4 * warp + 3] = c[0] * rho;
  }
  __syncthreads();
  bool shared = true, any = false;
  for (int k = 0; k < warps; ++k) {
    shared = shared && org[4 * k] && org[4 * k + 1] == org[1] && org[4 * k + 2] == org[2] &&
             org[4 * k + 3] == org[3] + k * rho;
    any = any || org[4 * k];
  }
  if (!any) return;  // every step invalid: the whole block, before any other barrier
#define LEGACY_CA3D_TILE(T)                                                                \
  if (vec)                                                                                 \
    legacy_ca3d_tile<T, 16 / sizeof(T), sizeof(T) == 8 ? 2 : 4>(                           \
        static_cast<T*>(out), static_cast<const T*>(in), reinterpret_cast<T*>(halo), org,  \
        shared, n, rho, shift, rs, rs1, zs, slice, slots);                                  \
  else                                                                                     \
    legacy_ca3d_tile<T, 1, 1>(static_cast<T*>(out), static_cast<const T*>(in),             \
                              reinterpret_cast<T*>(halo), org, shared, n, rho, shift, rs, rs1, \
                              zs, slice, slots)
  if constexpr (WIDE) {
    switch (dtype) {
      case SIMPLEX_I64: LEGACY_CA3D_TILE(long long); break;
      case SIMPLEX_BF16: LEGACY_CA3D_TILE(__nv_bfloat16); break;
      default: LEGACY_CA3D_TILE(__half); break;
    }
  } else {
    switch (dtype) {
      case SIMPLEX_I32: LEGACY_CA3D_TILE(int32_t); break;
      case SIMPLEX_F32: LEGACY_CA3D_TILE(float); break;
      case SIMPLEX_I8: LEGACY_CA3D_TILE(int8_t); break;
      case SIMPLEX_U8: LEGACY_CA3D_TILE(uint8_t); break;
      default: LEGACY_CA3D_TILE(int16_t); break;
    }
  }
#undef LEGACY_CA3D_TILE
}

// Host: whether a CA dtype code takes the WIDE kernel.
static inline bool legacy_ca3d_wide(int dtype) {
  return dtype == SIMPLEX_I64 || dtype == SIMPLEX_BF16 || dtype == SIMPLEX_F16;
}

// Host: the row stride of a halo `tiles` tiles wide: a lead piece, the
// cells and a trail piece, two pieces more where the row would be a
// multiple of four pieces (so that the tile's rows fall on distinct banks).
static int legacy_ca3d_row(int rho, int tiles, int pe, int vec) {
  const int rs = tiles * rho + 2 * pe;
  return vec && (rs / pe) % 4 == 0 ? rs + 2 * pe : rs;
}

// Host: the block's layout, as kernels/legacy.py CA3DKernel.layout states
// it: the warps a block (LEGACY_CA_WARPS, fewer where the shared halo
// would pass LEGACY_CA_BUDGET), the shared halo's row stride rs and the
// slice's rs1 (elements), the segment zs (planes a lane walks), one
// slice's elements, the slices the block's shared memory holds, and that
// memory in bytes.  False where one slice does not fit a block.
static bool legacy_ca3d_layout(int rho, int size, int vec, int* warps, int* rs, int* rs1,
                               int* zs, int* slice, int* slots, size_t* smem) {
  const int pe = vec ? 16 / size : 1, xw = vec ? (size == 8 ? 2 : 4) : 1;
  const size_t rows = (size_t)(rho + 2) * (rho + 2);
  *rs1 = legacy_ca3d_row(rho, 1, pe, vec);
  const size_t one = (rows * *rs1 * size + 15) & ~(size_t)15;
  if (16 * LEGACY_CA_WARPS + one > LEGACY_BLOCK_SMEM) return false;
  *slice = (int)(one / size);
  size_t halo = 0;
  for (*warps = LEGACY_CA_WARPS; *warps >= 1; --*warps) {
    *rs = legacy_ca3d_row(rho, *warps, pe, vec);
    halo = (rows * *rs * size + 15) & ~(size_t)15;
    if (*warps == 1 || halo <= LEGACY_CA_BUDGET) break;
  }
  *slots = (int)(halo / one);
  *smem = 16 * LEGACY_CA_WARPS + halo;
  const int vr = rho / xw, lr = vr < 32 ? vr : 32, chunks = (vr + 31) / 32;
  *zs = 1;
  for (int s = 1; s <= rho; ++s)
    if (rho % s == 0 && (long long)rho * s * chunks >= 32 / lr) {
      *zs = rho / s;
      break;
    }
  return true;
}

// dtype: a code of dtypes.cuh that CA takes (kernels/policy.py
// DTYPE_CODES); vec: 1 for 16-byte pieces (kernels/legacy.py
// CA3DKernel.vector_access), 0 for single cells.
extern "C" int legacy_ca3d_launch(void* out, const void* in, int dtype,
                                  const long long* header, const void* data, int n, int rho,
                                  int vec, void* stream) {
  SimplexMap map;
  int warps, rs, rs1, zs, slice, slots;
  size_t smem;
  if (!legacy_md_setup(header, data, 3, n, rho, &map) || !dt_ca_ok(dtype))
    return (int)cudaErrorInvalidValue;
  const int size = dt_bytes(dtype);
  if (vec && ((((uintptr_t)out | (uintptr_t)in) & 15) || (rho * size) % 16))
    return (int)cudaErrorInvalidValue;
  if (!legacy_ca3d_layout(rho, size, vec, &warps, &rs, &rs1, &zs, &slice, &slots, &smem))
    return (int)cudaErrorInvalidValue;
  if (map.steps == 0) return 0;
  const unsigned blocks = (unsigned)((map.steps + warps - 1) / warps);
  const int shift = legacy_pow2_shift(rho);
  cudaStream_t s = (cudaStream_t)stream;
#define LEGACY_CA3D(W)                                                                      \
  do {                                                                                      \
    if (smem > 48 * 1024) {                                                                 \
      cudaError_t e = cudaFuncSetAttribute(                                                 \
          legacy_ca3d_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);   \
      if (e != cudaSuccess) return (int)e;                                                  \
    }                                                                                       \
    legacy_ca3d_kernel<W><<<blocks, warps * 32, smem, s>>>(out, in, dtype, map, n, rho, shift, \
                                                          vec, rs, rs1, zs, slice, slots);  \
  } while (0)
  if (legacy_ca3d_wide(dtype))
    LEGACY_CA3D(1);
  else
    LEGACY_CA3D(0);
#undef LEGACY_CA3D
  return (int)cudaGetLastError();
}
