// Device side of repro_torch/core: the paper's block map H and its
// comparison maps, as functions of a launch's linear block index.
//
// One CUDA block (or, for MAP, one thread) takes the linear step index
// `lin`, evaluates the schedule's map in int32 and gets the math-order
// block coordinates (x_0, ..., x_{m-1}) plus a validity flag.  Array
// axis j of a domain array holds x_{m-1-j}.  The host packs a schedule
// into a SimplexMap with SimplexSchedule.device_descriptor(); the header
// layout and the map codes below match core/schedule.py (HEADER_LEN,
// MAP_CODES).  Every grid here is below 2^31 steps, so map arithmetic is
// int32 except the level prefixes of the recursion; element offsets in
// the kernels are int64.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define SIMPLEX_MAX_M 8
#define SIMPLEX_MAX_LEVELS 30
#define SIMPLEX_HEADER_LEN (8 + (SIMPLEX_MAX_LEVELS + 1) + SIMPLEX_MAX_LEVELS)

enum SimplexMapCode {
  MAP_HMAP2 = 0,      // hmap2_full over the (n/2, n+1) grid
  MAP_RB2 = 1,        // rb_map2 over the (n/2, n+1) grid
  MAP_BB2 = 2,        // (n, n) bounding box, valid iff x <= y
  MAP_BBMD = 3,       // n^m bounding box, valid iff sum < n
  MAP_HREC = 4,       // hmap_m_recursive (m >= 3 hmap / octant)
  MAP_COMPOSITE = 5,  // decompose_simplex pieces (or one split piece)
  MAP_TABLE = 6       // int32 (steps, m) table
};

struct SimplexLevels {
  int K;
  long long prefix[SIMPLEX_MAX_LEVELS + 1];
  int side[SIMPLEX_MAX_LEVELS];
};

struct SimplexMap {
  int code, m, n, steps, w, npieces, flip;
  SimplexLevels lv;
  const int* data;  // table or packed pieces (device), else nullptr
};

// Host: unpack the int64 header of core/schedule.py into the struct that
// is passed to the kernel by value.
static inline SimplexMap simplex_map_from_header(const long long* h,
                                                 const int* data) {
  SimplexMap M;
  M.code = (int)h[0];
  M.m = (int)h[1];
  M.n = (int)h[2];
  M.steps = (int)h[3];
  M.w = (int)h[4];
  M.lv.K = (int)h[5];
  M.npieces = (int)h[6];
  M.flip = (int)h[7];
  for (int k = 0; k <= SIMPLEX_MAX_LEVELS; ++k) M.lv.prefix[k] = h[8 + k];
  for (int k = 0; k < SIMPLEX_MAX_LEVELS; ++k)
    M.lv.side[k] = (int)h[8 + SIMPLEX_MAX_LEVELS + 1 + k];
  M.data = data;
  return M;
}

// Host: reject a header the device maps cannot serve.
static inline bool simplex_map_ok(const SimplexMap& M) {
  return M.m >= 2 && M.m <= SIMPLEX_MAX_M && M.steps >= 0 &&
         M.code >= MAP_HMAP2 && M.code <= MAP_TABLE &&
         M.lv.K >= 0 && M.lv.K <= SIMPLEX_MAX_LEVELS;
}

static __device__ __forceinline__ int simplex_pow2_floor(int y) {
  return 1 << (31 - __clz(y));  // Eq. 17/18; y >= 1
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
    int b = simplex_pow2_floor(wy);
    int q = wx / b;
    *x = wx + q * b;
    *y = wy + 2 * q * b;
  }
}

// The orthant recursion's level table for a power-of-two side (the host
// builds the same table as core/hmap.py::recursive_levels).
static __device__ void simplex_make_levels(int n, int m, SimplexLevels* L) {
  int K = 31 - __clz(n);
  L->K = K;
  L->prefix[0] = 0;
  long long cnt = 1;
  for (int k = 0; k < K; ++k) {
    int s = (k == K - 1) ? 2 : (n >> (k + 1));
    long long vol = 1;
    for (int j = 0; j < m; ++j) vol *= s;
    L->side[k] = s;
    L->prefix[k + 1] = L->prefix[k] + cnt * vol;
    cnt *= m;
  }
}

// hmap_m_recursive: linear idx -> (x_0..x_{m-1}), valid.
static __device__ bool simplex_hrec(int idx, int n, int m, const SimplexLevels& L,
                                    int* x) {
  int K = L.K;
  int level = 0;
  for (int k = 1; k < K; ++k)
    if ((long long)idx >= L.prefix[k]) ++level;
  int s = L.side[level];
  int bound = (level == K - 1) ? 2 : 2 * s;
  long long vol = 1;
  for (int j = 0; j < m; ++j) vol *= s;
  long long rem = (long long)idx - L.prefix[level];
  long long c = rem / vol;
  long long p = rem - c * vol;
  int lsum = 0;
  for (int j = 0; j < m; ++j) {  // x_0 fastest
    int l = (int)(p % s);
    p /= s;
    x[j] = l;
    lsum += l;
  }
  for (int j = 0; j < K - 1 && j < level; ++j) {
    int d = (int)(c % m);
    x[d] += n >> (j + 1);
    c /= m;
  }
  return lsum < bound;
}

// hmap_factor: one T^dim(side) factor of a composite piece.
static __device__ bool simplex_factor(int idx, int side, int dim, int* cs) {
  if (side == 1) {
    for (int j = 0; j < dim; ++j) cs[j] = 0;
    return true;
  }
  if (dim == 1) {
    cs[0] = idx;
    return true;
  }
  if (dim == 2) {
    int w = side / 2;
    int wy = idx / w;
    int wx = idx - wy * w;
    int col, row;
    simplex_hmap2_full(wx, wy, side, &col, &row);
    cs[0] = col;
    cs[1] = side - 1 - row;
    return true;
  }
  SimplexLevels L;
  simplex_make_levels(side, dim, &L);
  return simplex_hrec(idx, side, dim, L, cs);
}

// composite_map / piece_map: find the piece, decode its factor chain as
// trapezoids.py::_decode_piece does, pin invalid steps to the origin,
// and flip (u, v) -> (u, n-1-v) at m=2.
static __device__ bool simplex_composite(const SimplexMap& M, int lin, int* x) {
  const int P = M.npieces;
  const int* prefix = M.data;
  int lo = 0, hi = P - 1;  // last piece with prefix <= lin
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (prefix[mid] <= lin) lo = mid; else hi = mid - 1;
  }
  const int m = M.m;
  const int* rec = M.data + (P + 1) + lo * (1 + 4 * m);
  const int ng = rec[0];
  int rem = lin - prefix[lo];
  int dyn = 0;
  int top = m - 1;
  bool valid = true;
  for (int g = 0; g < ng; ++g) {
    const int dim = rec[1 + 4 * g], side = rec[2 + 4 * g], delta = rec[3 + 4 * g];
    int stride = 1;
    for (int h = g + 1; h < ng; ++h) stride *= rec[4 + 4 * h];
    int idx = rem / stride;
    rem -= idx * stride;
    int cs[SIMPLEX_MAX_M];
    valid = simplex_factor(idx, side, dim, cs) && valid;
    int sumz = 0;
    for (int j = 0; j < dim; ++j) sumz += cs[j];
    for (int j = 0; j < dim; ++j)
      x[top - (dim - 1) + j] = cs[j] + (j == dim - 1 ? dyn + delta : 0);
    dyn = side - sumz;
    top -= dim;
  }
  if (!valid)
    for (int j = 0; j < m; ++j) x[j] = 0;
  if (M.flip) x[1] = M.n - 1 - x[1];
  return valid;
}

// The schedule's map: linear step lin -> math-order block coordinates.
static __device__ bool simplex_map(const SimplexMap& M, int lin, int* x) {
  const int n = M.n;
  switch (M.code) {
    case MAP_HMAP2: {
      int wy = lin / M.w, wx = lin - wy * M.w;
      simplex_hmap2_full(wx, wy, n, &x[0], &x[1]);
      return true;
    }
    case MAP_RB2: {
      int wy = lin / M.w, wx = lin - wy * M.w;
      bool fold = wy <= wx;
      x[0] = fold ? n / 2 + wy : wx;
      x[1] = fold ? n / 2 + wx : wy - 1;
      return true;
    }
    case MAP_BB2: {
      int wy = lin / M.w, wx = lin - wy * M.w;
      x[0] = wx;
      x[1] = wy;
      return wx <= wy;
    }
    case MAP_BBMD: {
      int rem = lin, sum = 0;
      for (int j = 0; j < M.m; ++j) {
        x[j] = rem % n;
        rem /= n;
        sum += x[j];
      }
      return sum < n;
    }
    case MAP_HREC:
      return simplex_hrec(lin, n, M.m, M.lv, x);
    case MAP_COMPOSITE:
      return simplex_composite(M, lin, x);
    default: {  // MAP_TABLE
      const int* row = M.data + (long long)lin * M.m;
      for (int j = 0; j < M.m; ++j) x[j] = row[j];
      return true;
    }
  }
}

// Thread 0 evaluates the map for this block and the block shares it
// through s_blk (a __shared__ int[SIMPLEX_MAX_M + 1] of the kernel):
// array-axis block coordinates, then the valid flag.  Returns false for
// an invalid step, uniformly across the block, so the block can return.
static __device__ __forceinline__ bool simplex_block_shared(const SimplexMap& M,
                                                            int* s_blk) {
  if (threadIdx.x == 0) {
    int x[SIMPLEX_MAX_M];
    bool valid = simplex_map(M, (int)blockIdx.x, x);
    for (int j = 0; j < M.m; ++j) s_blk[j] = x[M.m - 1 - j];
    s_blk[SIMPLEX_MAX_M] = valid;
  }
  __syncthreads();
  return s_blk[SIMPLEX_MAX_M] != 0;
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
