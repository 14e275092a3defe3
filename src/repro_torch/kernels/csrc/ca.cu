// CA: one B3/S23 Game-of-Life step with 3^m - 1 neighbours on a state of
// any dtype CA takes (dtypes.cuh), from an input buffer into a separate
// output buffer that starts as a copy of the input (off-domain cells
// keep their input).
//
// Replaces: the TPU kernel of repro/kernels/engine.py _launch_domain
// with CABody and _assemble_halo (kernel table row 4), which fetched 3^m
// shifted tiles per step and stepped the state in place.  In place is
// sound on the TPU only because its grid runs in order over an aliased
// copy; blocks here run in no order, so this kernel reads only the
// input and writes only the output.
//
// Bound on the card: memory — each domain cell read once and written
// once, 2 * V * sizeof(T) bytes at 3.35 TB/s; the halo re-reads
// (rho+2)^m / rho^m of the input, mostly from L2.
//
// Design, ACCUM's (accum.cu) for a stencil:
// - One warp per schedule step, CA_WARPS steps a block (fewer where a
//   warp's halo is large).  Lane 0 evaluates the map once for the step
//   and broadcasts the block coordinates with __shfl_sync: no block
//   barrier behind one thread's map, and an invalid step's warp returns.
// - Each warp stages its step's (rho+2)^m halo in its own slice of
//   shared memory, masked as _assemble_halo masks it (m=2: periodic,
//   wrapped mod n and masked by the domain of its wrapped position;
//   m >= 3: free, 0 outside [0, n)^m or off the domain), as rows along
//   the last axis: (rho+2)^(m-1) halo rows of RS = rho + 2L cells, the
//   left edge cell at L - 1, the tile row's rho cells at L, the right
//   edge at L + rho.  Where a tile row is a whole number of 16-byte
//   pieces and both buffers start on a 16-byte boundary (the host's
//   fixed rule, the one engine.accum_vector_access states for ACCUM),
//   L is a piece's PE elements, so every row's cells from L sit on a
//   16-byte boundary: each lane loads whole pieces (a piece past the
//   domain's edge has its off-domain elements zeroed in registers) and
//   the two edge cells as scalars.  Otherwise L = PE = 1 and every cell
//   is a scalar load.  A halo row is decoded once per piece, never a
//   division by rho + 2 per cell.
// - The stencil has no offset table: a lane takes a piece of PE cells of
//   the tile and, for each of the 3^(m-1) neighbour rows in the
//   reference's order (itertools.product((-1, 0, 1), repeat=m), the
//   last axis fastest, the centre left out), loads that row's PE cells
//   and the two beside them, and adds left, middle, right into the PE
//   sums.  So each cell's count runs in the state's own type (Dt<T>:
//   integers wrap, 16-bit floats round after each add) in the
//   reference's order, and a state of any values gives its answer
//   bit for bit.  The neighbour rows are unrolled at compile time up to
//   m = 4 (27 rows); above, a loop counts them in the same order.
// - The result goes out as whole 16-byte pieces where the piece lies in
//   the domain, else element by element on the domain.
// - Latency: a lane issues the loads of CA_UNROLL halo pieces (or edge
//   cells) before it masks and stores any of them.
//   Two in flight took most of the gain of four at m=2 and m=3 in int32,
//   and four doubled this file's compile time.
// - Occupancy: a register cap (CA_BLOCKS blocks an SM, 64 registers a
//   thread), as ACCUM has; with loads in flight nothing spills at any m
//   (one at a time spilled at m=4, and a cap of 85 registers with three
//   blocks an SM was slower at m=3).
// The element type is a run-time code switched once per warp after the
// map, so the map is inlined once per m.  Element offsets are int64.
#include <stdint.h>

#include "dtypes.cuh"
#include "simplex_maps.cuh"

#define CA_WARPS 8            // schedule steps (warps) a block, at most
#define CA_BLOCKS 4           // blocks an SM: at most 64 registers a thread
#define CA_UNROLL 2           // halo loads a lane has in flight
#define CA_SMEM_LIMIT 232448  // a Hopper block's shared memory, bytes

// Elements a halo row holds: rho cells and a lead of L on each side.
static __host__ __device__ __forceinline__ int ca_row_stride(int rho, int lead) {
  return rho + 2 * lead;
}

// Bytes of one warp's halo slice, rounded up to 16.
static inline size_t ca_warp_bytes(int m, int rho, int lead, int itemsize) {
  size_t rows = 1;
  for (int j = 0; j < m - 1; ++j) rows *= rho + 2;
  return (rows * ca_row_stride(rho, lead) * itemsize + 15) & ~(size_t)15;
}

// Cells on the domain from array-axis coordinates g along the last axis:
// g, g + e_last, ... are on it for the first ca_run of them.
template <int M>
static __device__ __forceinline__ int ca_run(const int* g, int n) {
  if (M == 2) return g[0] - g[1] + 1;  // col <= row
  int s = 0;
#pragma unroll
  for (int j = 0; j < M; ++j) s += g[j];
  return n - s;  // sum < n
}

// PE elements of T as one load (a 16-byte piece, or one element).
template <typename T, int PE>
struct alignas(PE * sizeof(T)) CaPiece {
  T v[PE];
};

template <typename T, int PE>
static __device__ __forceinline__ CaPiece<T, PE> ca_load(const T* p) {
  CaPiece<T, PE> r;
  if constexpr (PE == 1) {
    r.v[0] = *p;
  } else {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    r = *reinterpret_cast<const CaPiece<T, PE>*>(&x);
  }
  return r;
}

template <typename T, int PE>
static __device__ __forceinline__ void ca_store(T* p, const CaPiece<T, PE>& r) {
  if constexpr (PE == 1)
    *p = r.v[0];
  else
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(&r);
}

// The array coordinates (axes 0..M-2) of halo row hr of block blk: its
// digits in base H, the last axis fastest, each one before the tile.
// Returns false for a row outside [0, n) on the free boundary; wraps
// into [0, n) on the periodic one.
template <int M>
static __device__ __forceinline__ bool ca_halo_row(int hr, const int* blk, int n, int rho,
                                                   int periodic, int* g) {
  const int H = rho + 2;
  bool ok = true;
#pragma unroll
  for (int j = M - 2; j >= 0; --j) {
    int d;
    if (j == 0) {
      d = hr;
    } else {
      d = hr % H;
      hr /= H;
    }
    int v = blk[j] * rho - 1 + d;
    if (periodic) v = v < 0 ? v + n : (v >= n ? v - n : v);
    else ok = ok && v >= 0 && v < n;
    g[j] = v;
  }
  return ok;
}

// One warp's tile in type T with PE elements a piece (16 bytes, or 1).
template <int M, typename T, int PE>
static __device__ __forceinline__ void ca_tile(T* __restrict__ out, const T* __restrict__ in,
                                               const int* blk, int n, int rho, int shift,
                                               int periodic, T* halo) {
  constexpr int L = PE;  // lead of a halo row
  const int lane = threadIdx.x & 31;
  const int H = rho + 2, RS = ca_row_stride(rho, L);
  const int vr = rho / PE;  // pieces a tile row
  const int hrows = simplex_ipow<M - 1>(H);
  const int xb = blk[M - 1] * rho;  // the tile's first cell on the last axis
  const T zero = Dt<T>::from_float(0.f);

  // 1. The halo's tile-row pieces: lane takes piece e = (halo row, k),
  // CA_UNROLL pieces in flight: all their loads, then the masks and stores.
  for (int base = lane; base < hrows * vr; base += 32 * CA_UNROLL) {
    CaPiece<T, PE> v[CA_UNROLL];
    int run[CA_UNROLL], at[CA_UNROLL];
#pragma unroll
    for (int u = 0; u < CA_UNROLL; ++u) {
      const int e = base + 32 * u;
      at[u] = -1;
      run[u] = 0;
      if (e < hrows * vr) {
        const int hr = e / vr, k = e - hr * vr;
        int g[M];
        const bool row_ok = ca_halo_row<M>(hr, blk, n, rho, periodic, g);
        g[M - 1] = xb + k * PE;
        run[u] = row_ok ? ca_run<M>(g, n) : 0;
        at[u] = hr * RS + L + k * PE;
        if (run[u] > 0) v[u] = ca_load<T, PE>(in + simplex_offset<M>(g, n));
      }
    }
#pragma unroll
    for (int u = 0; u < CA_UNROLL; ++u) {
      if (at[u] < 0) continue;
#pragma unroll
      for (int i = 0; i < PE; ++i)
        if (i >= run[u]) v[u].v[i] = zero;
      ca_store<T, PE>(halo + at[u], v[u]);
    }
  }
  // 2. The two edge cells of each halo row, wrapped or bounded, as many
  // in flight.
  for (int base = lane; base < 2 * hrows; base += 32 * CA_UNROLL) {
    T x[CA_UNROLL];
#pragma unroll
    for (int u = 0; u < CA_UNROLL; ++u) {
      const int e = base + 32 * u;
      x[u] = zero;
      if (e < 2 * hrows) {
        const int hr = e >> 1, right = e & 1;
        int g[M];
        bool ok = ca_halo_row<M>(hr, blk, n, rho, periodic, g);
        int c = right ? xb + rho : xb - 1;
        if (periodic) c = c < 0 ? c + n : (c >= n ? c - n : c);
        else ok = ok && c >= 0 && c < n;
        g[M - 1] = c;
        if (ok && simplex_in_domain<M>(g, n)) x[u] = in[simplex_offset<M>(g, n)];
      }
    }
#pragma unroll
    for (int u = 0; u < CA_UNROLL; ++u) {
      const int e = base + 32 * u;
      if (e < 2 * hrows) halo[(e >> 1) * RS + ((e & 1) ? L + rho : L - 1)] = x[u];
    }
  }
  __syncwarp();

  // 3. The tile: lane takes piece e = (tile row r, k), PE cells.
  constexpr int NR = (M == 2 ? 3 : M == 3 ? 9 : M == 4 ? 27 : M == 5 ? 81 : M == 6 ? 243
                      : M == 7 ? 729 : 2187);  // neighbour rows, 3^(M-1)
  const T one = Dt<T>::from_float(1.f);
  for (int e = lane; e < simplex_ipow<M - 1>(rho) * vr; e += 32) {
    int r = e / vr;
    const int k = e - r * vr;
    int g[M], hc = 0, hs = 1;  // the centre's halo row
#pragma unroll
    for (int j = M - 2; j >= 0; --j) {
      const int l = simplex_split(r, rho, shift);
      g[j] = blk[j] * rho + l;
      hc += (l + 1) * hs;
      hs *= H;
    }
    g[M - 1] = xb + k * PE;
    const int run = ca_run<M>(g, n);
    if (run <= 0) continue;  // the piece's first cell is off the domain: all are
    const T* centre = halo + hc * RS + L + k * PE;
    T acc[PE];
#pragma unroll
    for (int i = 0; i < PE; ++i) acc[i] = zero;
    // Neighbour row q: digit j of q (base 3, the last axis fastest) is
    // the offset + 1 along axis j; row NR / 2 holds the centre.
    auto row = [&](int q) {
      int off = 0, stride = RS;
#pragma unroll
      for (int j = M - 2, d = q; j >= 0; --j, d /= 3) {
        off += (d % 3 - 1) * stride;
        stride *= H;
      }
      const T* p = centre + off;
      const T left = p[-1], right = p[PE];
      const CaPiece<T, PE> mid = ca_load<T, PE>(p);
#pragma unroll
      for (int i = 0; i < PE; ++i) {
        acc[i] = Dt<T>::add(acc[i], i == 0 ? left : mid.v[i - 1]);
        if (q != NR / 2) acc[i] = Dt<T>::add(acc[i], mid.v[i]);  // not the centre itself
        acc[i] = Dt<T>::add(acc[i], i == PE - 1 ? right : mid.v[i + 1]);
      }
    };
    if constexpr (M <= 4) {
#pragma unroll
      for (int q = 0; q < NR; ++q) row(q);
    } else {
#pragma unroll 1
      for (int q = 0; q < NR; ++q) row(q);
    }
    const CaPiece<T, PE> c = ca_load<T, PE>(centre);
    CaPiece<T, PE> res;
#pragma unroll
    for (int i = 0; i < PE; ++i) {
      const bool three = Dt<T>::eq(acc[i], 3);
      const bool alive = (Dt<T>::eq(c.v[i], 0) && three) ||
                         (Dt<T>::eq(c.v[i], 1) && (Dt<T>::eq(acc[i], 2) || three));
      res.v[i] = alive ? one : zero;
    }
    T* dst = out + simplex_offset<M>(g, n);
    if (run >= PE) {
      ca_store<T, PE>(dst, res);
    } else {
#pragma unroll
      for (int i = 0; i < PE; ++i)
        if (i < run) dst[i] = res.v[i];
    }
  }
}

// dtype: a code of dtypes.cuh; vec: 16-byte pieces (see the note above);
// warp_bytes: one warp's halo slice.
template <int M>
__global__ void __launch_bounds__(CA_WARPS * 32, CA_BLOCKS)
simplex_ca_kernel(void* __restrict__ out, const void* __restrict__ in, int dtype,
                  const __grid_constant__ SimplexMap map, int n, int rho, int shift,
                  int periodic, int vec,
                  int warp_bytes) {
  extern __shared__ __align__(16) unsigned char smem_ca[];
  const int warp = threadIdx.x >> 5;
  const long long step = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (step >= map.steps) return;  // the whole warp
  int xs[M];
  int valid = 0;
  if ((threadIdx.x & 31) == 0) valid = simplex_map<M>(map, (int)step, xs);
  if (!__shfl_sync(0xffffffffu, valid, 0)) return;
  int blk[M];  // array-axis order
#pragma unroll
  for (int j = 0; j < M; ++j) blk[j] = __shfl_sync(0xffffffffu, xs[M - 1 - j], 0);
  unsigned char* halo = smem_ca + (size_t)warp * warp_bytes;
#define SIMPLEX_CA_TILE(T)                                                                 \
  if (vec)                                                                                 \
    ca_tile<M, T, (int)(16 / sizeof(T))>(static_cast<T*>(out), static_cast<const T*>(in), \
                                         blk, n, rho, shift, periodic,                    \
                                         reinterpret_cast<T*>(halo));                     \
  else                                                                                     \
    ca_tile<M, T, 1>(static_cast<T*>(out), static_cast<const T*>(in), blk, n, rho, shift, \
                     periodic, reinterpret_cast<T*>(halo))
  SIMPLEX_SWITCH_CA_DTYPE(dtype, SIMPLEX_CA_TILE)
#undef SIMPLEX_CA_TILE
}

// dtype: a code of dtypes.cuh that CA takes (kernels/policy.py
// DTYPE_CODES); vec: 1 for 16-byte pieces, which needs rho elements of
// the type to be a whole number of pieces and both buffers 16-byte
// aligned.  Warps a block: CA_WARPS, fewer where their halos would not
// fit a block's shared memory (kernels/engine.py CABody.smem_bytes).
extern "C" int simplex_ca_launch(void* out, const void* in, int dtype, int periodic, int vec,
                                 const long long* header, const void* data, int n, int rho,
                                 void* stream) {
  SimplexMap M;
  if (!simplex_map_unpack(header, data, &M) || rho < 1 || n % rho || !dt_ca_ok(dtype))
    return (int)cudaErrorInvalidValue;
  const int size = dt_bytes(dtype);
  if (vec && ((((uintptr_t)out | (uintptr_t)in) & 15) || (rho * size) % 16))
    return (int)cudaErrorInvalidValue;
  if (M.steps == 0) return 0;
  const size_t warp_bytes = ca_warp_bytes(M.m, rho, vec ? 16 / size : 1, size);
  if (warp_bytes > CA_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  int warps = CA_WARPS;
  while (warps > 1 && warp_bytes * warps > CA_SMEM_LIMIT) --warps;
  const size_t smem = warp_bytes * warps;
  const unsigned blocks = (unsigned)((M.steps + warps - 1) / warps);
  const int shift = simplex_rho_shift(rho);
  cudaStream_t s = (cudaStream_t)stream;
#define SIMPLEX_CA(MM)                                                                    \
  do {                                                                                    \
    if (smem > 48 * 1024) {                                                               \
      cudaError_t err = cudaFuncSetAttribute(                                             \
          simplex_ca_kernel<MM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem); \
      if (err != cudaSuccess) return (int)err;                                            \
    }                                                                                     \
    simplex_ca_kernel<MM><<<blocks, warps * 32, smem, s>>>(out, in, dtype, M, n, rho, shift, \
                                                          periodic, vec, (int)warp_bytes);  \
  } while (0)
  SIMPLEX_DISPATCH_M(M.m, SIMPLEX_CA)
#undef SIMPLEX_CA
  return (int)cudaGetLastError();
}
