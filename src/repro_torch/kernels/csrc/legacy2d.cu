// The frozen 2-D originals: MAP, ACCUM, EDM and CA over the paper's
// two-dimensional (w, h) grid.
//
// Replaces: the TPU kernels of repro/kernels/legacy.py map2d, accum2d,
// edm2d and ca2d (kernel table rows 7-10).  They are the independent
// differential baseline of the engine kernels (map.cu, accum.cu, edm.cu,
// ca.cu), so they share nothing with them beyond the m=2 map functions
// of the schedule subsystem: no linear-index simplex_map, no stencil
// table, no staging code.  Grid point (wx, wy) goes through the map H:
// Z^2 -> Z^2 to its (column, row) tile, the paper's CUDA formulation: for
// ACCUM and CA it is block (blockIdx.x, blockIdx.y), for EDM one of a
// block's run of wx at wy = blockIdx.y.  gridDim.y is capped at 65535, so
// a block loops over wy = blockIdx.y, blockIdx.y + gridDim.y, ... (the
// hmap/rb grid is (nb/2, nb+1) and nb reaches 65536 at rho = 1).
//
// On the TPU every grid step flushed its block back through input/output
// aliasing; here an invalid bb step writes nothing.  ACCUM updates the
// buffer it is given (the wrapper passes a copy), EDM writes the domain
// cells of a zero-seeded output, and CA reads one buffer and writes
// another that starts as a copy of the input, because blocks run in no
// order.
//
// Bounds on the card: MAP writes 12 bytes per step, ACCUM and CA read and
// write each domain cell once (memory); EDM writes each domain cell once
// and does d subtracts and d multiply-adds a cell (operations: 2 d lane
// operations a cell at 33.5 T a second, 0.51 ms at n = 16384, d = 64).
// Design of MAP, ACCUM and CA: one block per grid point, rho*rho elements
// per tile with the column fastest so neighbouring threads touch
// neighbouring addresses, a loop when rho*rho exceeds the block's 1024
// threads; CA stages the (rho+2)^2 periodic halo, each cell masked by its
// own wrapped position.  Element offsets are int64 (n = 65536 is a 16 GiB
// array).
//
// EDM (edm2d).  One block per grid point with a thread per cell read two
// floats of shared memory for each subtract and multiply-add: bound by
// shared-memory loads, with each tile's 8 KiB of points staged from L2
// behind a barrier.  Design:
// - Register blocks: a thread computes 4 x 4 cells of a tile, rows r +
//   tr i and columns 4 c + j (tr = tc = ceil(rho / 4) threads a tile
//   side; rows and columns past rho are computed and not stored, so any
//   rho works).  Per 4 values of k it loads 4 row and 4 column points' 16
//   bytes (8 loads) for 64 subtracts and 64 multiply-adds.  The points
//   are staged as they lie in memory, a point's k contiguous: point q at
//   q ld + 4 (q / 4) floats of its slot, ld / 4 odd.  A quarter warp (r
//   in {0, 1}, c in 0..3) then reads rows r and r + 1, 16-byte units ld /
//   4 apart, and columns 4 c + j, (4 ld / 4 + 1) c apart (an odd number of
//   units): distinct banks both.  A thread's 4 columns are contiguous, so
//   a row's 4 cells go out as one store (16 bytes in float32) where all
//   lie in the tile and on or below the diagonal.  At 4 x 4 the shared
//   memory's 128 bytes a clock and the CUDA cores' 128 lanes a clock are
//   matched (two bytes a cell and k against two lane operations); 8 x 4,
//   4 x 8 and 8 x 8 blocks load less a cell but were slower on an H100: a
//   grid point's 4.35 KiB of points in shared memory then serves fewer
//   threads, and fewer warps fill the SM.
// - The direct-difference form in float32 on the CUDA cores, as the
//   reference computes it (no tensor cores, no Gram form): each cell's
//   sum runs over k = 0 .. d-1 in order, t = p_r[k] - p_c[k] rounded,
//   then acc = fma(t, t, acc) (__fsub_rn, __fmaf_rn; one partial sum a
//   cell, since a thread's 16 cells already give 16 independent chains),
//   then __fsqrt_rn, rounded once to the output type.  Where d is not a
//   multiple of 4 the rows are padded with zeros, whose terms add +0
//   exactly.
// - Several grid points a block: block (bx, wy) takes the `tiles` grid
//   points wx = bx * tiles + g at one wy (the paper's (w, h) grid and its
//   gridDim.y loop for h > 65535 stay).  Such neighbours often share a
//   point block (hmap: one qb gives one row block y and consecutive
//   columns x; bb and rb's unfolded half: one y; rb's folded half: one x),
//   so warp 0 maps them, finds the distinct blocks at run time
//   (__match_any_sync and a ballot) and the block stages each once: tiles
//   + 1 blocks for `tiles` tiles instead of 2 tiles.  Where they do not fit
//   the slots (the hmap rows wy < tiles, whose qb changes every 2^lb
//   points) the points go in passes.
// - Staging: cp.async, 16-byte pieces where d is a multiple of 4 and the
//   points start on a 16-byte boundary (kernels/legacy.py
//   legacy_vector_access(d, 4, ptr)), else 4 bytes; every copy of a pass
//   is in flight at once and holds no register.  A block's staging
//   overlaps the other blocks' products on the SM (44 KB a block at rho
//   = 16, d = 64: five blocks an SM at 96 registers a thread).
//   Overlapping it with the block's own products (two sets of slots, a
//   block walking four grid rows) was slower on an H100: twice the shared
//   memory left two blocks an SM.
//
// Element types are the reference's: ACCUM and CA run in the array's own
// type and EDM computes in float32 and stores the points' type
// (dtypes.cuh holds that arithmetic; the wrapper stages EDM's points as
// float32).
#include <limits.h>

#include "dtypes.cuh"
#include "simplex_maps.cuh"

enum Legacy2DKind { LEGACY2D_HMAP = 0, LEGACY2D_RB = 1, LEGACY2D_BB = 2 };

// (wx, wy) -> column block x, row block y; false for a bb step above the
// diagonal.  nb is the tile count of a side.
static __device__ __forceinline__ bool legacy2d_map(int kind, int wx, int wy, int nb,
                                                    int* x, int* y) {
  if (kind == LEGACY2D_HMAP) {
    simplex_hmap2_full(wx, wy, nb, x, y);
    return true;
  }
  if (kind == LEGACY2D_RB) {  // the RB fold [37]
    const bool fold = wy <= wx;
    *x = fold ? nb / 2 + wy : wx;
    *y = fold ? nb / 2 + wx : wy - 1;
    return true;
  }
  *x = wx;
  *y = wy;
  return wx <= wy;
}

// Host: the (w, h) grid of kind at nb tiles a side; false where the kind
// has no such grid (hmap needs a power of two, rb an even side).
static bool legacy2d_grid(int kind, int nb, int* w, int* h) {
  if (nb < 1) return false;
  if (kind == LEGACY2D_BB) {
    *w = nb;
    *h = nb;
    return true;
  }
  const bool ok = (kind == LEGACY2D_HMAP && nb >= 2 && (nb & (nb - 1)) == 0) ||
                  (kind == LEGACY2D_RB && nb >= 2 && nb % 2 == 0);
  *w = nb / 2;
  *h = nb + 1;
  return ok;
}

// Host: checks common to the tile kernels; sets the launch shape and the
// grid height h the blocks loop over.
static bool legacy2d_tile_launch(int kind, int nb, int n, int rho, dim3* grid, int* h,
                                 int* threads) {
  int w;
  if (rho < 1 || (long long)nb * rho != n || !legacy2d_grid(kind, nb, &w, h) ||
      (long long)rho * rho > INT_MAX)
    return false;
  *grid = dim3(w, *h < 65535 ? *h : 65535);
  *threads = rho * rho < 1024 ? rho * rho : 1024;
  return true;
}

// ---------------------------------------------------------------------------
// MAP: (x, y, valid) per grid step, one thread per step, chunk per block.
// ---------------------------------------------------------------------------

__global__ void legacy_map2d_kernel(int* __restrict__ out, int kind, int nb, int w,
                                    int steps) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lin = (int)(row < steps - 1 ? row : steps - 1);  // pad rows repeat the last
  const int wy = lin / w;
  const int wx = lin - wy * w;
  int x, y;
  const bool valid = legacy2d_map(kind, wx, wy, nb, &x, &y);
  out[row * 3 + 0] = x;
  out[row * 3 + 1] = y;
  out[row * 3 + 2] = valid;
}

// out: (rows, 3) int32 with rows = steps rounded up to whole chunks.
extern "C" int legacy_map2d_launch(void* out, int kind, int nb, int chunk, long long rows,
                                   void* stream) {
  int w, h;
  if (!legacy2d_grid(kind, nb, &w, &h) || chunk < 1 || chunk > 1024)
    return (int)cudaErrorInvalidValue;
  const long long steps = (long long)w * h;
  const long long blocks = (steps + chunk - 1) / chunk;
  if (steps >= INT_MAX || rows != blocks * chunk) return (int)cudaErrorInvalidValue;
  legacy_map2d_kernel<<<(unsigned)blocks, chunk, 0, (cudaStream_t)stream>>>(
      (int*)out, kind, nb, w, (int)steps);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// ACCUM: +1 on the inclusive lower triangle {col <= row}, in place.
// ---------------------------------------------------------------------------

template <typename T>
static __device__ __forceinline__ void legacy_accum2d_body(T* __restrict__ x, int kind, int nb,
                                                           int h, int n, int rho) {
  const int wx = blockIdx.x;
  const int tile = rho * rho;
  for (int wy = blockIdx.y; wy < h; wy += gridDim.y) {
    int xb, yb;
    if (!legacy2d_map(kind, wx, wy, nb, &xb, &yb)) continue;
    for (int e = threadIdx.x; e < tile; e += blockDim.x) {
      const int i = e / rho;
      const int r = yb * rho + i;
      const int c = xb * rho + (e - i * rho);
      if (c <= r) {
        const long long off = (long long)r * n + c;
        x[off] = Dt<T>::add(x[off], Dt<T>::from_float(1.f));
      }
    }
  }
}

// dtype: a code of dtypes.cuh that ACCUM takes, switched once at the top
// (the same code in every thread) into a body typed throughout.
__global__ void legacy_accum2d_kernel(void* __restrict__ x, int dtype, int kind, int nb, int h,
                                      int n, int rho) {
#define LEGACY_ACCUM2D_BODY(T) legacy_accum2d_body<T>(static_cast<T*>(x), kind, nb, h, n, rho)
  SIMPLEX_SWITCH_DTYPE(dtype, LEGACY_ACCUM2D_BODY)
#undef LEGACY_ACCUM2D_BODY
}

// dtype: a code of dtypes.cuh that ACCUM takes (kernels/policy.py DTYPE_CODES).
extern "C" int legacy_accum2d_launch(void* x, int dtype, int kind, int nb, int n, int rho,
                                     void* stream) {
  dim3 grid;
  int h, threads;
  if (!dt_accum_ok(dtype) || !legacy2d_tile_launch(kind, nb, n, rho, &grid, &h, &threads))
    return (int)cudaErrorInvalidValue;
  legacy_accum2d_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(x, dtype, kind, nb, h, n,
                                                                    rho);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// EDM: out[r, c] = sqrt(sum_k (p[r, k] - p[c, k])^2) where c <= r.
// ---------------------------------------------------------------------------

#define LEGACY_EDM_ROWS 4          // a thread's cells: rows of a tile
#define LEGACY_EDM_COLS 4          // and columns (4: a store of four cells; the slot's pad)
#define LEGACY_EDM_THREADS 128     // a block's threads, at most (grid points are added to fill it)
#define LEGACY_EDM_BLOCKS 5        // blocks an SM: at most 96 registers a thread
#define LEGACY_EDM_MAX_TILES 16    // two map lanes a grid point in one warp
#define LEGACY_EDM_TABLE 96        // ints of a pass's table: 32 + 32 + slots + 2
#define LEGACY_EDM_SMEM 232448     // a block's shared memory, bytes
#define LEGACY_FULL 0xffffffffu

// Four output cells written as one store.
template <typename OutT>
struct alignas(4 * sizeof(OutT)) LegacyFour {
  OutT v[4];
};

// One piece into shared memory by cp.async: 16 bytes (vec) or 4.
static __device__ __forceinline__ void legacy_edm_copy(float* dst, const float* src, bool vec) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

// Host: the block's shape at tile side rho and d coordinates, as
// kernels/legacy.py EDM2DKernel.layout states it: tr = ceil(rho / ROWS)
// threads down a tile and tc = ceil(rho / COLS) across (a thread's ROWS x
// COLS cells), a slot of max(ROWS tr, COLS tc) points of ld floats (ld /
// 4 odd, so the points a quarter warp reads at once fall on distinct
// banks), `tiles` grid points a block (at most w, the grid's width) and
// `slots` point blocks staged at once (two where a block has one grid
// point, else tiles + 2: one shared block and one of each point's own,
// with a spare for a run whose shared block changes).  Returns the
// block's shared memory, or 0 where one grid point does not fit.
static size_t legacy_edm2d_layout(int rho, int d, int w, int* tr, int* tc, int* ld, int* tiles,
                                  int* slots) {
  *tr = (rho + LEGACY_EDM_ROWS - 1) / LEGACY_EDM_ROWS;
  *tc = (rho + LEGACY_EDM_COLS - 1) / LEGACY_EDM_COLS;
  const int k4 = (d + 3) / 4;
  *ld = 4 * (k4 % 2 ? k4 : k4 + 1);
  const int pts = LEGACY_EDM_ROWS * *tr > LEGACY_EDM_COLS * *tc ? LEGACY_EDM_ROWS * *tr
                                                                 : LEGACY_EDM_COLS * *tc;
  const size_t slot = (size_t)4 * (pts * *ld + pts);  // bytes
  int g = LEGACY_EDM_THREADS / (*tr * *tc);
  g = g < 1 ? 1 : (g > LEGACY_EDM_MAX_TILES ? LEGACY_EDM_MAX_TILES : g);
  g = g > w ? w : g;
  for (;; --g) {
    const int s = g == 1 ? 2 : g + 2;
    const size_t bytes = slot * s + sizeof(int) * LEGACY_EDM_TABLE;
    if (bytes <= LEGACY_EDM_SMEM || g == 1) {
      *tiles = g;
      *slots = s;
      return bytes <= LEGACY_EDM_SMEM ? bytes : 0;
    }
  }
}

// One block: `tiles` grid points (wx0 + g, wy), g < tiles, for each wy it
// walks.  Warp 0 maps them, one lane per (point, side): lane 2g holds
// point g's row block, lane 2g + 1 its column block, -1 for no tile (past
// the grid, or an invalid bb step).  A pass takes the longest run of
// points from g0 on whose distinct blocks fit the slots (all of them but
// on a few hmap rows): __match_any_sync gives each lane the first lane
// from 2 g0 on that holds its block, a ballot numbers the distinct blocks,
// each is staged once (k fastest, a point's ld floats, the pad k >= d held
// 0), and the pass's tiles' threads compute their cells.
template <typename OutT>
static __device__ __forceinline__ void legacy_edm2d_body(OutT* __restrict__ out,
                                                         const float* __restrict__ p, int d,
                                                         int kind, int nb, int w, int h, int n,
                                                         int rho, int vec, int dshift, int tr,
                                                         int tc, int ld, int tiles, int slots,
                                                         unsigned char* smem) {
  const int tid = threadIdx.x, nthreads = blockDim.x, lane = tid & 31;
  const int pts = LEGACY_EDM_ROWS * tr > LEGACY_EDM_COLS * tc ? LEGACY_EDM_ROWS * tr
                                                              : LEGACY_EDM_COLS * tc;
  const int ss = pts * ld + pts;  // floats a slot: 4 of pad after every 4 points
  const int k4 = (d + 3) & ~3;
  float* s_pts = reinterpret_cast<float*>(smem);
  // the pass's table: each lane's block [32], its slot [32], the block in
  // each slot [slots], the pass's end point and slot count [2]
  int* s_id = reinterpret_cast<int*>(smem + (size_t)4 * ss * slots);
  int* s_slot = s_id + 32;
  int* s_blk = s_slot + 32;
  int* s_pass = s_blk + slots;
  // The pad k in [d, k4) of every point stays 0: (0 - 0)^2 adds +0.
  for (int e = tid; e < slots * pts * (k4 - d); e += nthreads) {
    const int q = e / (k4 - d), sl = q / pts, pt = q - sl * pts;
    s_pts[sl * ss + pt * ld + (pt >> 2) * 4 + d + (e - q * (k4 - d))] = 0.f;
  }
  const int wx0 = blockIdx.x * tiles;
  const int per = tr * tc;            // threads a tile
  const int units = vec ? d / 4 : d;  // copies a point
  for (int wy = blockIdx.y; wy < h; wy += gridDim.y) {
    int id = -1;  // warp 0's lane: the block of its (point, side)
    if (tid < 32) {
      const int g = lane >> 1;
      int xb, yb;
      if (g < tiles && wx0 + g < w && legacy2d_map(kind, wx0 + g, wy, nb, &xb, &yb))
        id = lane & 1 ? xb : yb;
      s_id[lane] = id;
    }
    for (int g0 = 0; g0 < tiles;) {
      if (tid < 32) {
        const unsigned from = LEGACY_FULL << (2 * g0);  // lanes 2 g0 .. 31 (g0 < 16)
        const int first = __ffs(__match_any_sync(LEGACY_FULL, id) & from) - 1;
        const bool mine = lane >= 2 * g0 && id >= 0;
        const unsigned firsts = __ballot_sync(LEGACY_FULL, mine && first == lane);
        const int upto = __popc(firsts & (LEGACY_FULL >> (31 - lane)));
        const unsigned fit = __ballot_sync(
            LEGACY_FULL, (lane & 1) && lane >= 2 * g0 && (lane >> 1) < tiles && upto <= slots);
        const int g1 = (32 - __clz(fit)) >> 1;
        const unsigned taken = firsts & (g1 >= 16 ? LEGACY_FULL : (1u << (2 * g1)) - 1);
        const int slot = __shfl_sync(LEGACY_FULL, __popc(taken & ((1u << lane) - 1)),
                                     first < 0 ? 0 : first);
        if (mine && lane < 2 * g1) {
          s_slot[lane] = slot;
          if (first == lane) s_blk[slot] = id;
        }
        if (lane == 0) {
          s_pass[0] = g1;
          s_pass[1] = __popc(taken);
        }
      }
      __syncthreads();
      const int g1 = s_pass[0], staged = s_pass[1];
      for (int s = 0; s < staged; ++s) {  // a block's rho points are rho * d floats in a row
        const float* src = p + (long long)s_blk[s] * rho * d;
        float* dst = s_pts + s * ss;
        for (int e = tid; e < rho * units; e += nthreads) {
          const int q = dshift >= 0 ? e >> dshift : e / units;
          const int k = (e - q * units) * (vec ? 4 : 1);
          legacy_edm_copy(dst + q * ld + (q >> 2) * 4 + k, src + (long long)e * (vec ? 4 : 1),
                          vec != 0);
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      for (int e = tid; e < tiles * per; e += nthreads) {
        const int g = e / per;
        const int yb = s_id[2 * g], xb = s_id[2 * g + 1];
        if (g < g0 || g >= g1 || yb < 0) continue;
        const int r = (e - g * per) / tc, c = e - g * per - r * tc;
        // rows r + tr i and columns 4 c + j of the tile; point q sits at
        // q ld + 4 (q / 4) in its slot, so the points a quarter warp reads
        // at once fall on distinct banks (see the note above)
        const float* a = s_pts + s_slot[2 * g] * ss;
        int at[LEGACY_EDM_ROWS];
#pragma unroll
        for (int i = 0; i < LEGACY_EDM_ROWS; ++i) {
          const int q = r + tr * i;
          at[i] = q * ld + (q >> 2) * 4;
        }
        const float* b = s_pts + s_slot[2 * g + 1] * ss + LEGACY_EDM_COLS * c * ld + c * 4;
        float acc[LEGACY_EDM_ROWS][LEGACY_EDM_COLS];
#pragma unroll
        for (int i = 0; i < LEGACY_EDM_ROWS; ++i)
#pragma unroll
          for (int j = 0; j < LEGACY_EDM_COLS; ++j) acc[i][j] = 0.f;
#pragma unroll 2
        for (int k = 0; k < k4; k += 4) {
          float4 u[LEGACY_EDM_ROWS], v[LEGACY_EDM_COLS];
#pragma unroll
          for (int i = 0; i < LEGACY_EDM_ROWS; ++i)
            u[i] = *reinterpret_cast<const float4*>(a + at[i] + k);
#pragma unroll
          for (int j = 0; j < LEGACY_EDM_COLS; ++j)
            v[j] = *reinterpret_cast<const float4*>(b + j * ld + k);
          // each cell's sum runs over k in order, one rounding a term
#define LEGACY_EDM_TERM(F)                                                \
  _Pragma("unroll") for (int i = 0; i < LEGACY_EDM_ROWS; ++i)              \
      _Pragma("unroll") for (int j = 0; j < LEGACY_EDM_COLS; ++j) {        \
    const float t = __fsub_rn(u[i].F, v[j].F);                             \
    acc[i][j] = __fmaf_rn(t, t, acc[i][j]);                                \
  }
          LEGACY_EDM_TERM(x)
          LEGACY_EDM_TERM(y)
          LEGACY_EDM_TERM(z)
          LEGACY_EDM_TERM(w)
#undef LEGACY_EDM_TERM
        }
        // a row's 4 cells as one store where they are all inside the tile
        // and on or below the diagonal (rho a multiple of 4 keeps it
        // aligned), else cell by cell
        const int col0 = LEGACY_EDM_COLS * c, C0 = xb * rho + col0;
#pragma unroll
        for (int i = 0; i < LEGACY_EDM_ROWS; ++i) {
          const int row = r + tr * i;
          if (row >= rho) continue;
          const int R = yb * rho + row;
          OutT* dst = out + (long long)R * n + C0;
          LegacyFour<OutT> f;
#pragma unroll
          for (int j = 0; j < LEGACY_EDM_COLS; ++j)
            f.v[j] = Dt<OutT>::from_float(__fsqrt_rn(acc[i][j]));
          if ((rho & 3) == 0 && col0 + 3 < rho && C0 + 3 <= R) {
            *reinterpret_cast<LegacyFour<OutT>*>(dst) = f;
          } else {
#pragma unroll
            for (int j = 0; j < LEGACY_EDM_COLS; ++j)
              if (col0 + j < rho && C0 + j <= R) dst[j] = f.v[j];
          }
        }
      }
      __syncthreads();  // the slots and the table are free again
      g0 = g1;
    }
  }
}

// out_dtype: the floating code of dtypes.cuh the output is stored in,
// switched once at the top into a body typed throughout.  At most
// LEGACY_EDM_THREADS threads a block, LEGACY_EDM_BLOCKS blocks an SM
// (ptxas then keeps a thread's registers at 96 or fewer).
__global__ void __launch_bounds__(LEGACY_EDM_THREADS, LEGACY_EDM_BLOCKS)
legacy_edm2d_kernel(void* __restrict__ out, int out_dtype, const float* __restrict__ p, int d,
                    int kind, int nb, int w, int h, int n, int rho, int vec, int dshift, int tr,
                    int tc, int ld, int tiles, int slots) {
  extern __shared__ __align__(16) unsigned char s_edm[];
#define LEGACY_EDM2D_BODY(T)                                                              \
  legacy_edm2d_body<T>(static_cast<T*>(out), p, d, kind, nb, w, h, n, rho, vec, dshift, tr, \
                       tc, ld, tiles, slots, s_edm)
  switch (out_dtype) {
    case SIMPLEX_F64: LEGACY_EDM2D_BODY(double); break;
    case SIMPLEX_BF16: LEGACY_EDM2D_BODY(__nv_bfloat16); break;
    case SIMPLEX_F16: LEGACY_EDM2D_BODY(__half); break;
    default: LEGACY_EDM2D_BODY(float); break;
  }
#undef LEGACY_EDM2D_BODY
}

// out_dtype: the floating code of dtypes.cuh the output is stored in; the
// points are float32; vec: 1 to stage them in 16-byte pieces (d a
// multiple of 4 and p on a 16-byte boundary: kernels/legacy.py
// legacy_vector_access(d, 4, p)), 0 one float at a time.  The grid is
// (ceil(w / tiles), min(h, 65535)).
extern "C" int legacy_edm2d_launch(void* out, int out_dtype, const void* p, int d, int kind,
                                   int nb, int n, int rho, int vec, void* stream) {
  int w, h, tr, tc, ld, tiles, slots;
  if (d < 1 || !dt_float_ok(out_dtype) || rho < 1 || (long long)nb * rho != n ||
      !legacy2d_grid(kind, nb, &w, &h) || (vec && (d % 4 || ((uintptr_t)p & 15))))
    return (int)cudaErrorInvalidValue;
  const size_t smem = legacy_edm2d_layout(rho, d, w, &tr, &tc, &ld, &tiles, &slots);
  if (!smem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        legacy_edm2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int units = vec ? d / 4 : d;
  const int dshift = (units & (units - 1)) ? -1 : __builtin_ctz(units);
  const int per = tr * tc;  // whole warps: warp 0 maps the block's grid points
  const int threads =
      ((tiles * per < LEGACY_EDM_THREADS ? tiles * per : LEGACY_EDM_THREADS) + 31) & ~31;
  const dim3 grid((w + tiles - 1) / tiles, h < 65535 ? h : 65535);
  legacy_edm2d_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      out, out_dtype, (const float*)p, d, kind, nb, w, h, n, rho, vec, dshift, tr, tc, ld, tiles,
      slots);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// CA: one B3/S23 step on the triangle of a periodic square, in -> out.
// ---------------------------------------------------------------------------

template <typename T>
static __device__ __forceinline__ void legacy_ca2d_body(T* __restrict__ out,
                                                        const T* __restrict__ in, int kind,
                                                        int nb, int h, int n, int rho,
                                                        unsigned char* smem) {
  T* s_halo = reinterpret_cast<T*>(smem);  // (rho+2)^2, origin one cell up and left
  const T zero = Dt<T>::from_float(0.f);
  const int hs = rho + 2;
  const int wx = blockIdx.x;
  const int tile = rho * rho;
  for (int wy = blockIdx.y; wy < h; wy += gridDim.y) {
    int xb, yb;
    if (!legacy2d_map(kind, wx, wy, nb, &xb, &yb)) continue;  // uniform in the block
    __syncthreads();  // the last tile's reads of the halo are done
    for (int e = threadIdx.x; e < hs * hs; e += blockDim.x) {
      const int hi = e / hs;
      int R = yb * rho + hi - 1;
      int C = xb * rho + (e - hi * hs) - 1;
      R = R < 0 ? R + n : (R >= n ? R - n : R);
      C = C < 0 ? C + n : (C >= n ? C - n : C);
      s_halo[e] = C <= R ? in[(long long)R * n + C] : zero;  // off the triangle: dead
    }
    __syncthreads();
    for (int e = threadIdx.x; e < tile; e += blockDim.x) {
      const int i = e / rho;
      const int j = e - i * rho;
      const int r = yb * rho + i;
      const int c = xb * rho + j;
      if (c > r) continue;
      const T* q = s_halo + (i + 1) * hs + (j + 1);
      const T centre = q[0];
      // the reference's order (rows, then columns), in the state's own type
      T neigh = Dt<T>::add(Dt<T>::add(Dt<T>::add(q[-hs - 1], q[-hs]), q[-hs + 1]), q[-1]);
      neigh = Dt<T>::add(Dt<T>::add(Dt<T>::add(Dt<T>::add(neigh, q[1]), q[hs - 1]), q[hs]),
                         q[hs + 1]);
      const bool three = Dt<T>::eq(neigh, 3);
      const bool alive = (Dt<T>::eq(centre, 0) && three) ||
                         (Dt<T>::eq(centre, 1) && (Dt<T>::eq(neigh, 2) || three));
      out[(long long)r * n + c] = Dt<T>::from_float(alive ? 1.f : 0.f);
    }
  }
}

// dtype: a code of dtypes.cuh that CA takes, switched once at the top into
// a body typed throughout.
__global__ void legacy_ca2d_kernel(void* __restrict__ out, const void* __restrict__ in,
                                   int dtype, int kind, int nb, int h, int n, int rho) {
  extern __shared__ __align__(16) unsigned char s_raw[];
#define LEGACY_CA2D_BODY(T) \
  legacy_ca2d_body<T>(static_cast<T*>(out), static_cast<const T*>(in), kind, nb, h, n, rho, s_raw)
  SIMPLEX_SWITCH_CA_DTYPE(dtype, LEGACY_CA2D_BODY)
#undef LEGACY_CA2D_BODY
}

// dtype: a code of dtypes.cuh that CA takes (kernels/policy.py DTYPE_CODES).
extern "C" int legacy_ca2d_launch(void* out, const void* in, int dtype, int kind, int nb,
                                  int n, int rho, void* stream) {
  dim3 grid;
  int h, threads;
  if (!dt_ca_ok(dtype) || !legacy2d_tile_launch(kind, nb, n, rho, &grid, &h, &threads))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)dt_bytes(dtype) * (size_t)(rho + 2) * (rho + 2);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        legacy_ca2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  legacy_ca2d_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(out, in, dtype, kind, nb,
                                                                    h, n, rho);
  return (int)cudaGetLastError();
}
