// Device side of repro_torch/core: the paper's block map H and its
// comparison maps, as functions of a launch's linear block index.
//
// One CUDA block, warp or thread takes the linear step index `lin`,
// evaluates the schedule's map in int32 and gets the math-order block
// coordinates (x_0, ..., x_{m-1}) plus a validity flag.  Array axis j of
// a domain array holds x_{m-1-j}.  The host packs a schedule into an
// int64 header with SimplexSchedule.device_descriptor(); the header
// layout and the map codes below match core/schedule.py (HEADER_LEN,
// SHARD_AT, MAP_CODES).  Every grid here is below 2^31 steps, so all map
// arithmetic is int32; element offsets in the kernels are int64.
//
// A launch may walk a shard of the schedule (distributed/
// simplex_sharding.py): at most two ranges of its steps, described by
// the header's last slots as (launch steps, a0, l0, a1).  Launch step
// lin is the schedule's step lin < l0 ? a0 + lin : a1 + (lin - l0); the
// map then decodes that step as it decodes any, so a shard of an hmap,
// recursion or composite walk keeps the map's arithmetic and reuses the
// schedule's table or pieces on the device.  The whole walk is
// (steps, 0, steps, 0).  SimplexMap.steps is the launch's count, which
// bounds every kernel's grid; the header's own steps slot stays the
// schedule's, which the recursion's level check reads.
//
// A map evaluation lives in registers (ptxas: no stack frame):
// - simplex_map is templated on the compile-time dimension M, as every
//   kernel that calls it is (SIMPLEX_DISPATCH_M), so x[M] and every loop
//   over the coordinates unroll; the map code stays a run-time switch.
// - The kernel takes the map as a small `const __grid_constant__`
//   SimplexMap with no table in it: the recursion's levels are walked
//   arithmetically (every side is a power of two, so each division by a
//   side or a cube volume is a shift), and the host checks that the
//   header's level table is the one that walk gives.  A division by a
//   power of two known only at run time is a shift too.
// - Coordinates go into x through loops over the compile-time positions
//   with a run-time test (a composite factor's positions, the axis a
//   recursion path digit moves), never through a run-time index into an
//   array.  The tests select values rather than guard stores: a store
//   under `q == first` lets the compiler rewrite x[q] as x[first], a
//   run-time index, and at m = 8 in EDM that put x in local memory.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define SIMPLEX_MAX_M 8
#define SIMPLEX_MAX_LEVELS 30
#define SIMPLEX_SHARD_SLOTS 4
#define SIMPLEX_SHARD_AT (8 + (SIMPLEX_MAX_LEVELS + 1) + SIMPLEX_MAX_LEVELS)
#define SIMPLEX_HEADER_LEN (SIMPLEX_SHARD_AT + SIMPLEX_SHARD_SLOTS)

enum SimplexMapCode {
  MAP_HMAP2 = 0,      // hmap2_full over the (n/2, n+1) grid
  MAP_RB2 = 1,        // rb_map2 over the (n/2, n+1) grid
  MAP_BB2 = 2,        // (n, n) bounding box, valid iff x <= y
  MAP_BBMD = 3,       // n^m bounding box, valid iff sum < n
  MAP_HREC = 4,       // hmap_m_recursive (m >= 3 hmap / octant)
  MAP_COMPOSITE = 5,  // decompose_simplex pieces (or one split piece)
  MAP_TABLE = 6       // int32 (steps, m) table
};

// What a kernel needs of a schedule: the header's scalars and the int32
// payload (the level table stays on the host).
struct SimplexMap {
  int code, m, n;
  int steps;  // the launch's steps (a shard's, or the whole walk's)
  int w;  // the 2-D grid's width (axis 0)
  int K;  // recursion levels, n = 2^K
  int npieces, flip;
  int a0, l0, d1;  // launch step lin walks lin + (lin < l0 ? a0 : d1), d1 = a1 - l0
  const int* data;  // table or packed pieces (device), else nullptr
};

// Host: whether the header's level table (prefix[0..K], side[0..K-1],
// core/hmap.py::recursive_levels) is the one the device walks for
// n = 2^K at dimension m: level k holds m^k cubes of side 2^lg,
// lg = max(K - 1 - k, 1), so prefix[k+1] = prefix[k] + m^k 2^(m lg).
static inline bool simplex_levels_ok(const long long* h, int m, int n, int K, int steps) {
  if (K < 1 || K > SIMPLEX_MAX_LEVELS || (1LL << K) != n) return false;
  const long long* prefix = h + 8;
  const long long* side = h + 8 + SIMPLEX_MAX_LEVELS + 1;
  long long at = 0, cubes = 1;
  for (int k = 0; k < K; ++k) {
    const int lg = K - 1 - k > 1 ? K - 1 - k : 1;
    if (side[k] != (1LL << lg) || prefix[k] != at || m * lg > 31 || cubes > INT_MAX)
      return false;
    at += cubes << (m * lg);
    if (at > INT_MAX) return false;
    cubes *= m;
  }
  return prefix[K] == at && at == steps;
}

// Host: unpack the int64 header of core/schedule.py and reject what the
// device maps cannot serve, a launch range outside the walk included.
static inline bool simplex_map_unpack(const long long* h, const void* data, SimplexMap* M) {
  const long long* launch = h + SIMPLEX_SHARD_AT;  // steps, a0, l0, a1
  M->code = (int)h[0];
  M->m = (int)h[1];
  M->n = (int)h[2];
  M->steps = (int)launch[0];
  M->w = (int)h[4];
  M->K = (int)h[5];
  M->npieces = (int)h[6];
  M->flip = (int)h[7];
  M->a0 = (int)launch[1];
  M->l0 = (int)launch[2];
  M->d1 = (int)(launch[3] - launch[2]);
  M->data = (const int*)data;
  if (h[1] < 2 || h[1] > SIMPLEX_MAX_M || h[3] < 0 || h[3] > INT_MAX || h[2] < 1 ||
      h[2] > INT_MAX || h[4] < 0 || h[4] > INT_MAX)
    return false;
  if (launch[0] < 0 || launch[0] > INT_MAX || launch[1] < 0 || launch[2] < 0 ||
      launch[2] > launch[0] || launch[3] < 0 || launch[1] + launch[2] > h[3] ||
      launch[3] + (launch[0] - launch[2]) > h[3])
    return false;
  if (M->steps > 0 && (M->code == MAP_COMPOSITE || M->code == MAP_TABLE) && !data)
    return false;
  switch (M->code) {
    case MAP_HMAP2:
    case MAP_RB2:
    case MAP_BB2:
      return M->m == 2 && M->w >= 1;
    case MAP_BBMD:
    case MAP_TABLE:
      return true;
    case MAP_HREC:
      return M->m >= 3 && simplex_levels_ok(h, M->m, M->n, M->K, (int)h[3]);
    case MAP_COMPOSITE:
      return M->npieces >= 1;
    default:
      return false;
  }
}

// hmap2_full: zero-waste inclusive-diagonal map, grid (n/2, n+1).
static __device__ __forceinline__ void simplex_hmap2_full(int wx, int wy, int n,
                                                          int* x, int* y) {
  if (wy == 0) {
    *x = wx;
    *y = wx;
  } else if (wy == n) {
    *x = n / 2 + wx;
    *y = n / 2 + wx;
  } else {
    const int lb = 31 - __clz(wy);  // b = 2^lb, the power of two below wy (Eq. 17/18)
    const int qb = (wx >> lb) << lb;
    *x = wx + qb;
    *y = wy + 2 * qb;
  }
}

// a / d for a >= 0, d >= 1: a shift where d is a power of two.
static __device__ __forceinline__ int simplex_div(int a, int d) {
  return (d & (d - 1)) ? a / d : a >> (__ffs(d) - 1);
}

// hmap_m_recursive over T^dim(2^K) at index idx, walked without a table,
// added into the zeros at positions first .. first + dim - 1 of x (the
// cell's coordinate j at position first + j).  Level k holds dim^k cubes
// of side 2^lg, lg = max(K - 1 - k, 1): idx's level, the cube's number c
// and the index p inside it (coordinate j is bits [j lg, (j+1) lg) of p)
// come from shifts, and base-dim digit i of c moves its axis by
// 2^(K-1) >> i.  Returns the cell's validity.
template <int M>
static __device__ __forceinline__ bool simplex_hrec(int idx, int K, int dim, int first,
                                                    int (&x)[M]) {
  int base = 0, cubes = 1, level = 0;
  for (; level < K - 1; ++level) {
    const int size = cubes << (dim * (K - 1 - level));  // side 2^(K-1-level) here
    if (idx - base < size) break;
    base += size;
    cubes *= dim;
  }
  const int lg = max(K - 1 - level, 1), rem = idx - base;
  int c = rem >> (dim * lg);
  const int p = rem - (c << (dim * lg)), mask = (1 << lg) - 1;
  int lsum = 0;
#pragma unroll
  for (int q = 0; q < M; ++q) {
    const int j = q - first;
    if (j >= 0 && j < dim) {
      const int l = (p >> (j * lg)) & mask;
      x[q] += l;
      lsum += l;
    }
  }
  for (int i = 0; i < level; ++i) {
    const int cq = c / dim, d = first + c - cq * dim;
#pragma unroll
    for (int q = 0; q < M; ++q) x[q] += q == d ? (1 << (K - 1)) >> i : 0;
    c = cq;
  }
  return lsum < (level == K - 1 ? 2 : 2 << lg);
}

// hmap_factor: one T^dim(side) factor of a composite piece, added into
// the zeros at positions first .. first + dim - 1 of x: a point (side
// 1), an interval (dim 1), a triangle (dim 2) or the recursion.
template <int M>
static __device__ __forceinline__ bool simplex_factor(int idx, int side, int dim, int first,
                                                      int (&x)[M]) {
  if (side == 1) return true;
  if (dim >= 3) return simplex_hrec<M>(idx, 31 - __clz(side), dim, first, x);
  int a = idx, b = 0;
  if (dim == 2) {
    const int wy = simplex_div(idx, side / 2);
    int row;
    simplex_hmap2_full(idx - wy * (side / 2), wy, side, &a, &row);
    b = side - 1 - row;
  }
#pragma unroll
  for (int q = 0; q < M; ++q) x[q] = q == first ? a : (q == first + 1 && dim == 2 ? b : x[q]);
  return true;
}

// composite_map / piece_map: find the piece, decode its factor chain as
// trapezoids.py::_decode_piece does (factor g fills the positions
// top - dim + 1 .. top, the first factor the highest), pin invalid steps
// to the origin, and flip (u, v) -> (u, n-1-v) at m=2.
template <int M>
static __device__ __forceinline__ bool simplex_composite(const SimplexMap& map, int lin,
                                                         int (&x)[M]) {
  const int* prefix = map.data;
  int lo = 0, hi = map.npieces - 1;  // last piece with prefix <= lin
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (prefix[mid] <= lin) lo = mid; else hi = mid - 1;
  }
  const int* rec = map.data + (map.npieces + 1) + lo * (1 + 4 * M);
  const int groups = rec[0];
  int rem = lin - prefix[lo], dyn = 0, top = M - 1;
  bool valid = true;
#pragma unroll
  for (int q = 0; q < M; ++q) x[q] = 0;
  for (int g = 0; g < groups; ++g) {
    const int dim = rec[1 + 4 * g], side = rec[2 + 4 * g], delta = rec[3 + 4 * g];
    int stride = 1;
    for (int h = g + 1; h < groups; ++h) stride *= rec[4 + 4 * h];
    const int idx = simplex_div(rem, stride);
    rem -= idx * stride;
    const int first = top - (dim - 1);
    valid = simplex_factor<M>(idx, side, dim, first, x) && valid;
    int sumz = 0;
#pragma unroll
    for (int q = 0; q < M; ++q) {
      if (q >= first && q <= top) sumz += x[q];
      x[q] += q == top ? dyn + delta : 0;
    }
    dyn = side - sumz;
    top -= dim;
  }
  if (!valid) {
#pragma unroll
    for (int q = 0; q < M; ++q) x[q] = 0;
  }
  if (map.flip) x[1] = map.n - 1 - x[1];
  return valid;
}

// The schedule's map: linear launch step lin -> math-order block
// coordinates.  M is the schedule's m (the host dispatches on it).
template <int M>
static __device__ __forceinline__ bool simplex_map(const SimplexMap& map, int lin,
                                                   int (&x)[M]) {
  lin += lin < map.l0 ? map.a0 : map.d1;  // the schedule's step
  const int n = map.n;
  switch (map.code) {
    case MAP_HMAP2:
    case MAP_RB2:
    case MAP_BB2: {
      if constexpr (M == 2) {
        const int wy = simplex_div(lin, map.w), wx = lin - wy * map.w;
        if (map.code == MAP_HMAP2) {
          simplex_hmap2_full(wx, wy, n, &x[0], &x[1]);
          return true;
        }
        if (map.code == MAP_RB2) {
          const bool fold = wy <= wx;
          x[0] = fold ? n / 2 + wy : wx;
          x[1] = fold ? n / 2 + wx : wy - 1;
          return true;
        }
        x[0] = wx;
        x[1] = wy;
        return wx <= wy;
      }
      return false;  // the host sends 2-D codes at m = 2 only
    }
    case MAP_BBMD: {
      int rem = lin, sum = 0;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const int q = simplex_div(rem, n);
        x[j] = rem - q * n;
        rem = q;
        sum += x[j];
      }
      return sum < n;
    }
    case MAP_HREC: {
      if constexpr (M >= 3) {
#pragma unroll
        for (int j = 0; j < M; ++j) x[j] = 0;
        return simplex_hrec<M>(lin, map.K, M, 0, x);
      }
      return false;  // the host sends the recursion at m >= 3 only
    }
    case MAP_COMPOSITE:
      return simplex_composite<M>(map, lin, x);
    default: {  // MAP_TABLE
      const int* row = map.data + (long long)lin * M;
#pragma unroll
      for (int j = 0; j < M; ++j) x[j] = row[j];
      return true;
    }
  }
}

// Host: log2(rho) when rho is a power of two, else -1 (divide instead).
static inline int simplex_rho_shift(int rho) {
  if (rho < 1 || (rho & (rho - 1))) return -1;
  int s = 0;
  while ((1 << s) < rho) ++s;
  return s;
}

// Next digit of r in base rho (shift >= 0: rho is 2^shift).
static __device__ __forceinline__ int simplex_split(int& r, int rho, int shift) {
  int l;
  if (shift >= 0) {
    l = r & (rho - 1);
    r >>= shift;
  } else {
    l = r % rho;
    r /= rho;
  }
  return l;
}

// The repo-wide domain predicate on element coordinates in array-axis
// order: m=2 inclusive lower triangle {col <= row}, m >= 3 {sum < n}.
template <int M>
static __device__ __forceinline__ bool simplex_in_domain(const int* g, int n) {
  if (M == 2) return g[1] <= g[0];
  int s = 0;
#pragma unroll
  for (int j = 0; j < M; ++j) s += g[j];
  return s < n;
}

// Row-major int64 offset of array-axis coordinates g in an (n,)*M array.
template <int M>
static __device__ __forceinline__ long long simplex_offset(const int* g, int n) {
  long long off = 0;
#pragma unroll
  for (int j = 0; j < M; ++j) off = off * n + g[j];
  return off;
}

template <int M>
static __device__ __forceinline__ int simplex_ipow(int b) {
  int p = 1;
#pragma unroll
  for (int j = 0; j < M; ++j) p *= b;
  return p;
}

// Launch KERNEL<m, ...> for the runtime m (2..SIMPLEX_MAX_M): the kernels
// are templated on m so that their per-element loops unroll into
// registers.  LAUNCH(M) is a macro body that uses the constant M.
#define SIMPLEX_DISPATCH_M(m, LAUNCH)        \
  switch (m) {                               \
    case 2: LAUNCH(2); break;                \
    case 3: LAUNCH(3); break;                \
    case 4: LAUNCH(4); break;                \
    case 5: LAUNCH(5); break;                \
    case 6: LAUNCH(6); break;                \
    case 7: LAUNCH(7); break;                \
    case 8: LAUNCH(8); break;                \
    default: return (int)cudaErrorInvalidValue; \
  }
