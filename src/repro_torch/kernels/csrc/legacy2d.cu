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
// MAP it is a thread, for ACCUM, EDM and CA one of a block's run of wx at
// wy = blockIdx.y.  gridDim.y is capped at 65535, so a block loops over wy
// = blockIdx.y, blockIdx.y + gridDim.y, ... (the hmap/rb grid is (nb/2,
// nb+1) and nb reaches 65536 at rho = 1).
//
// On the TPU every grid step flushed its block back through input/output
// aliasing; here an invalid bb step writes nothing.  ACCUM updates the
// buffer it is given (the wrapper passes a copy), EDM writes the domain
// cells of a zero-seeded output, and CA reads one buffer and writes
// another that starts as a copy of the input, because blocks run in no
// order.
//
// Bounds on the card: MAP writes 12 bytes per step, ACCUM and CA read and
// write each domain cell once (memory: 0.3205 ms at n = 16384 in int32);
// EDM writes each domain cell once and does d subtracts and d
// multiply-adds a cell (operations: 2 d lane operations a cell at 33.5 T
// a second, 0.51 ms at n = 16384, d = 64).  MAP: one thread per step.
// Element offsets are int64 (n = 65536 is a 16 GiB array).
//
// The blocks of ACCUM and CA.  A block per grid point with a thread per
// cell had every thread evaluate the map, divide by rho at every cell and
// touch 64-byte tile rows 64 KiB apart (524,800 blocks of 256 threads at
// n = 16384, rho = 16; bb launched one for each of its 523,776 grid points
// above the diagonal too).  Design: a warp per grid point, LEGACY2D_WARPS
// = 8 a block at one wy (wx = 8 bx + g).  Lanes g < 8 of every warp
// evaluate the map of grid point g (a few shifts at m = 2), so every warp
// learns by ballots and shuffles, with no table and no barrier, whether
// the block's valid points are a prefix whose tiles lie side by side
// along x (SIDE), a prefix stacked along y (STACK), or neither (ALONE); a
// block with none goes on to its next row at once.  At n = 16384, rho =
// 16 (nb 1024) the valid points' shares, SIDE / STACK / ALONE, are hmap
// 99.12 / 0 / 0.88 % (qb is constant over 8 aligned wx once wy >= 8), rb
// 74.63 / 24.68 / 0.68 % (the unfolded half wy > wx side by side, the
// folded half stacked) and bb 100 / 0 / 0 % (a block's valid points are a
// prefix), where 65,024 of bb's 131,072 blocks have none
// (tests/test_torch_legacy2d_walk.py).
//
// ACCUM (accum2d).  Where the tiles line up the block's threads walk
// their rectangle together, a thread two pieces in flight: 8 tiles side
// by side are rows of 8 rho contiguous cells, 512 bytes at rho = 16 in
// int32, one 16-byte piece a lane, so a warp reads and writes whole
// 512-byte runs; otherwise each warp walks its own tile.  16-byte pieces
// where kernels/legacy.py legacy_vector_access says so (rho elements are
// whole pieces, x on a 16-byte boundary), else one element a lane.  Per
// piece the diagonal run r + 1 - c is computed once: a piece with none is
// not touched, and in a piece that straddles the diagonal the cells past
// it are written back unchanged, which is safe because a tile belongs to
// exactly one grid point.  The dtype and the access path are switched
// once at the top into a body typed throughout, each with its own
// grid-row loop: one loop around the switch kept every type's invariants
// live and spilled (168 bytes of stack at 64 registers); typed loops keep
// 62 registers, no frame.  On an H100 80GB HBM3 at 700 W, n = 16384, rho
// = 16, int32: 0.498 ms at hmap in chip_smoke.py, 64 % of the bound (0.456
// in scripts/legacy_variants.py), rb 0.560, bb 0.543.  Variants that lost
// (legacy_variants.py, same card): a warp per tile everywhere
// 1.01-1.05x; six blocks an SM (a 40-register cap) spill, 1.03-1.05x;
// four pieces a lane spill, 1.46-1.52x; loads without the 128-byte L2
// fetch 1.00-1.09x (rb's stacked tiles, 64-byte rows, lose most).
//
// CA (ca2d).  Where the tiles line up the block stages one halo, else
// each warp with a tile stages its own (rho+2)^2 halo in a slice, `slots`
// warps a round (every warp at once where the slices fit
// LEGACY2D_CA_BUDGET).  SIDE: (rho+2) rows of a lead cell, 8 rho cells
// and a trail cell; STACK: (8 rho + 2) rows of rho cells; fewer warps a
// block where either would pass the budget (rho 32 in int64: 6, rho 64
// in int32: 3).  A halo row's middle goes by cp.async in 16-byte pieces
// where kernels/legacy.py CA2DKernel.vector_access says so (rho cells
// are whole pieces, both buffers on a 16-byte boundary, a slice fits),
// cell by cell elsewhere; every cell is masked by col <= row at its own
// wrapped position, so a row's middle is one run, lim = R + 1 with R the
// wrapped row, zero-filled past it, and the wrapped lead and trail cells
// (column -1 -> n - 1, column n -> 0) go as scalars.  Then a lane takes
// XW cells of a tile row (a 16-, 8- or 4-byte load: 4 cells of a type up
// to 4 bytes, 2 of int64; 1 on the scalar path) and walks y over ys rows
// (the host's rule, CA2DKernel.layout: as few segments as keep the
// warp's lanes busy, ys = 2 at rho = 16 in int32) with the row sums R =
// (h[x-1] + h[x]) + h[x+1] of the rows before, at and after its row in
// registers; the x neighbours come from the lanes beside it by
// __shfl_up/down_sync, or from shared memory for a row's first and last
// lane.  The count is ((R[y-1] + R[y]) + R[y+1]) - centre, in an unsigned
// integer of at least 32 bits for integer states (bit-equal to the plain
// version at any values once cut back to the state's type) and in
// float32 for floating states (bit-equal wherever every partial sum is
// exact in float32 and in the state's type: always on 0/1 states; not on
// floating states of other values, where the plain version rounds each
// add in the state's type).  A lane's XW cells go out as one store where
// they all lie on the triangle, else cell by cell.  Two instantiations,
// as ca3d's in legacy_md.cu: WIDE = 0 (8-, 16- and 32-bit integers,
// float32) at 64 registers, WIDE = 1 (int64, bfloat16, float16) at 74,
// neither with a frame or a spill.  Same card and case: 0.690 ms at hmap
// in chip_smoke.py, 46 % of the bound, rb 0.720, bb 0.705.  What bounds
// it (legacy_variants.py): staging alone (no_count) takes 0.387 ms and
// the count alone (no_stage) 0.338 against 0.693 for both, so the two
// barely overlap, and registers hold the SM at four blocks of 8 warps:
// five blocks ran 0.90-0.93x but spill at 48 registers.  Lost: a halo a
// warp, 1.07-1.10x.
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
// The block's grid points, shared by ACCUM and CA: block (bx, wy) takes
// the `warps` grid points wx = bx * warps + g at one wy, warp g grid
// point g.
// ---------------------------------------------------------------------------

#define LEGACY2D_WARPS 8     // grid points (warps) a block, at most
#define LEGACY2D_FULL 0xffffffffu
enum Legacy2DMode { LEGACY2D_SIDE = 0, LEGACY2D_STACK = 1, LEGACY2D_ALONE = 2 };

// The block's tiles as every warp sees them.  valid: bit g for grid
// point g with a tile; mode: SIDE where the valid points are a prefix g <
// cnt whose tiles lie side by side along x from (x0, y0), STACK where
// they are a prefix stacked along y (at least two), else ALONE; (xb, yb):
// this warp's own tile.
struct Legacy2DBlock {
  unsigned valid;
  int mode, cnt, x0, y0, xb, yb;
};

// Lanes g < warps of every warp evaluate the map of grid point g, so each
// warp learns the block's tiles by ballots and shuffles, with no table in
// shared memory and no barrier; the map is a few shifts at m = 2.
static __device__ __forceinline__ Legacy2DBlock legacy2d_block(int kind, int wx0, int wy, int w,
                                                               int nb, int warps) {
  const int lane = threadIdx.x & 31;
  int x = 0, y = 0;
  const bool v =
      lane < warps && wx0 + lane < w && legacy2d_map(kind, wx0 + lane, wy, nb, &x, &y);
  Legacy2DBlock b;
  b.valid = __ballot_sync(LEGACY2D_FULL, v);
  b.cnt = __popc(b.valid);
  b.x0 = __shfl_sync(LEGACY2D_FULL, x, 0);
  b.y0 = __shfl_sync(LEGACY2D_FULL, y, 0);
  b.xb = __shfl_sync(LEGACY2D_FULL, x, threadIdx.x >> 5);
  b.yb = __shfl_sync(LEGACY2D_FULL, y, threadIdx.x >> 5);
  const bool prefix = b.valid == (1u << b.cnt) - 1;  // cnt <= 8
  const bool side =
      __all_sync(LEGACY2D_FULL, !v || (y == b.y0 && x == b.x0 + lane));
  const bool stack =
      __all_sync(LEGACY2D_FULL, !v || (x == b.x0 && y == b.y0 + lane));
  b.mode = prefix && side ? LEGACY2D_SIDE
                          : (prefix && stack && b.cnt > 1 ? LEGACY2D_STACK : LEGACY2D_ALONE);
  return b;
}

// Host: checks common to ACCUM and CA; sets the grid's width w and height
// h the blocks loop over.
static bool legacy2d_tile_launch(int kind, int nb, int n, int rho, int* w, int* h) {
  return rho >= 1 && (long long)nb * rho == n && legacy2d_grid(kind, nb, w, h) &&
         (long long)rho * rho <= INT_MAX;
}

// ---------------------------------------------------------------------------
// ACCUM: +1 on the inclusive lower triangle {col <= row}, in place.
// ---------------------------------------------------------------------------

#define LEGACY2D_ACCUM_BLOCKS 4  // blocks an SM: at most 64 registers a thread
#define LEGACY2D_UNROLL 2        // pieces a lane has in flight

// A 16-byte piece read with the L2 fetching the 128 bytes around it.
static __device__ __forceinline__ uint4 legacy2d_load_piece(const void* p) {
  uint4 v;
  asm volatile("ld.global.L2::128B.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// +1 on the triangle's cells of a rectangle of `rows` rows of rp pieces
// (EV elements each: 16 bytes, or one element) from element (r0, c0), by
// thread t of nt, LEGACY2D_UNROLL pieces a thread in flight; consecutive
// threads take consecutive pieces of a row (rshift: log2 rp, or -1 to
// divide).  Per piece the run of cells on or below the diagonal, r + 1 -
// c, is computed once: a piece with none is not touched, and in a piece
// that straddles the diagonal the cells past it are written back
// unchanged (a tile belongs to one grid point).
template <typename T, int EV>
static __device__ __forceinline__ void legacy_accum2d_rect(T* __restrict__ x, int n, int r0,
                                                           int c0, int rows, int rp, int rshift,
                                                           int t, int nt) {
  const T one = Dt<T>::from_float(1.f);
  const int pieces = rows * rp;
  for (int base = t; base < pieces; base += nt * LEGACY2D_UNROLL) {
    uint4 v[LEGACY2D_UNROLL];
    T s[LEGACY2D_UNROLL];
    T* p[LEGACY2D_UNROLL];
    int run[LEGACY2D_UNROLL];
#pragma unroll
    for (int u = 0; u < LEGACY2D_UNROLL; ++u) {
      const int e = base + u * nt;
      run[u] = 0;
      if (e < pieces) {
        const int i = rshift >= 0 ? e >> rshift : e / rp;
        const int r = r0 + i, c = c0 + (e - i * rp) * EV;
        run[u] = r + 1 - c;  // the piece's cells with c <= r
        p[u] = x + (long long)r * n + c;
        if (run[u] > 0) {
          if constexpr (EV > 1)
            v[u] = legacy2d_load_piece(p[u]);
          else
            s[u] = *p[u];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < LEGACY2D_UNROLL; ++u) {
      if (run[u] <= 0) continue;  // the piece lies above the diagonal (or past the rectangle)
      if constexpr (EV > 1) {
        T* el = reinterpret_cast<T*>(&v[u]);
#pragma unroll
        for (int i = 0; i < EV; ++i)
          if (i < run[u]) el[i] = Dt<T>::add(el[i], one);
        *reinterpret_cast<uint4*>(p[u]) = v[u];
      } else {
        *p[u] = Dt<T>::add(s[u], one);
      }
    }
  }
}

// The grid rows of one block in type T, EV elements a piece: every warp
// maps the block's grid points (legacy2d_block) and a block with no tile
// goes on to its next row.  Where its tiles line up (side by side or
// stacked) the block's threads walk their rectangle together, so a warp
// takes whole rows of the block (8 tiles side by side are 8 rho contiguous
// cells); otherwise each warp walks its own tile.
template <typename T, int EV>
static __device__ __forceinline__ void legacy_accum2d_rows(T* __restrict__ x, int kind, int nb,
                                                           int w, int h, int n, int rho) {
  const int warps = blockDim.x >> 5;
  const int vr = rho / EV;  // pieces a tile row
  for (int wy = blockIdx.y; wy < h; wy += gridDim.y) {
    const Legacy2DBlock b = legacy2d_block(kind, blockIdx.x * warps, wy, w, nb, warps);
    if (!b.valid) continue;  // every grid point invalid: a bb block above the diagonal
    const bool together = b.mode != LEGACY2D_ALONE;
    if (together) {
      const bool stack = b.mode == LEGACY2D_STACK;
      const int rows = stack ? b.cnt * rho : rho, rp = stack ? vr : b.cnt * vr;
      legacy_accum2d_rect<T, EV>(x, n, b.y0 * rho, b.x0 * rho, rows, rp,
                                 (rp & (rp - 1)) ? -1 : __ffs(rp) - 1, threadIdx.x, blockDim.x);
    } else if ((b.valid >> (threadIdx.x >> 5)) & 1) {
      legacy_accum2d_rect<T, EV>(x, n, b.yb * rho, b.xb * rho, rho, vr,
                                 (vr & (vr - 1)) ? -1 : __ffs(vr) - 1, threadIdx.x & 31, 32);
    }
  }
}

// dtype: a code of dtypes.cuh that ACCUM takes and vec (16-byte pieces),
// switched once at the top into a body typed throughout.  The switch comes
// before the map, not after it as in legacy_md.cu: the m = 2 map is a few
// shifts, so each typed body inlines it at no cost, and a grid-row loop
// around the switch kept every type's loop invariants live and spilled.
__global__ void __launch_bounds__(LEGACY2D_WARPS * 32, LEGACY2D_ACCUM_BLOCKS)
legacy_accum2d_kernel(void* __restrict__ x, int dtype, int kind, int nb, int w, int h, int n,
                      int rho, int vec) {
#define LEGACY_ACCUM2D_ROWS(T)                                                              \
  if (vec)                                                                                  \
    legacy_accum2d_rows<T, 16 / sizeof(T)>(static_cast<T*>(x), kind, nb, w, h, n, rho);     \
  else                                                                                      \
    legacy_accum2d_rows<T, 1>(static_cast<T*>(x), kind, nb, w, h, n, rho)
  SIMPLEX_SWITCH_DTYPE(dtype, LEGACY_ACCUM2D_ROWS)
#undef LEGACY_ACCUM2D_ROWS
}

// dtype: a code of dtypes.cuh that ACCUM takes (kernels/policy.py
// DTYPE_CODES); vec: 1 for 16-byte pieces (kernels/legacy.py
// legacy_vector_access: rho elements are whole pieces and x starts on a
// 16-byte boundary), 0 for single elements.  The grid is (ceil(w /
// warps), min(h, 65535)), LEGACY2D_WARPS warps a block (one where eight
// tiles would pass an int's pieces).
extern "C" int legacy_accum2d_launch(void* x, int dtype, int kind, int nb, int n, int rho,
                                     int vec, void* stream) {
  int w, h;
  if (!dt_accum_ok(dtype) || !legacy2d_tile_launch(kind, nb, n, rho, &w, &h) ||
      (vec && (((uintptr_t)x & 15) || (rho * dt_bytes(dtype)) % 16)))
    return (int)cudaErrorInvalidValue;
  const int warps = (long long)LEGACY2D_WARPS * rho * rho <= INT_MAX ? LEGACY2D_WARPS : 1;
  const dim3 grid((w + warps - 1) / warps, h < 65535 ? h : 65535);
  legacy_accum2d_kernel<<<grid, warps * 32, 0, (cudaStream_t)stream>>>(x, dtype, kind, nb, w, h,
                                                                       n, rho, vec);
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

#define LEGACY2D_CA_BLOCKS 4            // blocks an SM: at most 64 registers a thread
#define LEGACY2D_CA_BLOCKS_WIDE 3       // for the wide counts: at most 85
#define LEGACY2D_CA_BUDGET (56 * 1024)  // a shared halo's bytes, at most (four blocks an SM)
#define LEGACY2D_BLOCK_SMEM 232448      // a block's shared memory, bytes

// The neighbour count's type A for states of type T: integers add in an
// unsigned type of at least 32 bits (a count cut back to T wraps as T's
// own adds do), floating states in float32.
template <typename T>
struct Legacy2DCount;
#define LEGACY2D_COUNT_INT(T, U, AA)                                                          \
  template <>                                                                                 \
  struct Legacy2DCount<T> {                                                                   \
    using A = AA;                                                                             \
    static __device__ __forceinline__ A widen(T v) { return (A)(U)v; }                        \
    static __device__ __forceinline__ bool is(A a, int v) { return (U)a == (U)(T)v; }         \
  };
LEGACY2D_COUNT_INT(int8_t, uint8_t, uint32_t)
LEGACY2D_COUNT_INT(uint8_t, uint8_t, uint32_t)
LEGACY2D_COUNT_INT(int16_t, uint16_t, uint32_t)
LEGACY2D_COUNT_INT(int32_t, uint32_t, uint32_t)
LEGACY2D_COUNT_INT(long long, unsigned long long, unsigned long long)
#undef LEGACY2D_COUNT_INT
#define LEGACY2D_COUNT_FLOAT(T, WIDEN)                                                        \
  template <>                                                                                 \
  struct Legacy2DCount<T> {                                                                   \
    using A = float;                                                                          \
    static __device__ __forceinline__ A widen(T v) { return WIDEN(v); }                       \
    static __device__ __forceinline__ bool is(A a, int v) { return a == (float)v; }           \
  };
LEGACY2D_COUNT_FLOAT(float, (float))
LEGACY2D_COUNT_FLOAT(__nv_bfloat16, __bfloat162float)
LEGACY2D_COUNT_FLOAT(__half, __half2float)
#undef LEGACY2D_COUNT_FLOAT

// The halo of a rectangle of tiles, by thread t of nt: `rows` halo rows
// from array row r0 (r0 = -1 for a halo over the first tile row), each
// holding, at hr * rs, the wrapped lead cell at PE - 1, the `cells` cells
// from column c0 at PE .. PE + cells - 1 and the wrapped trail cell at PE +
// cells.  Every cell is masked at its own wrapped position: it keeps its
// value where col <= row, else 0, so a row's middle is one run, lim = R +
// 1 in wrapped coordinates.  The middle goes in 16-byte pieces by cp.async
// (PE > 1: `bytes` of it read, the rest zero-filled, no register held),
// else cell by cell; the lead and trail cells as scalars.  A row's parts
// (lead, cells / PE pieces, trail) go to consecutive threads, and a
// thread's row and part advance by nt parts without a division.
template <typename T, int PE>
static __device__ __forceinline__ void legacy_ca2d_stage(T* halo, const T* __restrict__ in,
                                                         int r0, int c0, int n, int rows,
                                                         int cells, int rs, int t, int nt) {
  const T zero = Dt<T>::from_float(0.f);
  const int parts = cells / PE + 2;
  const int dr = nt / parts, dp = nt - dr * parts;
  int hr = t / parts, p = t - hr * parts;
  while (hr < rows) {
    int R = r0 + hr;
    R = R < 0 ? R + n : (R >= n ? R - n : R);
    const T* src = in + (long long)R * n;
    T* dst = halo + hr * rs;
    if (p == 0 || p == parts - 1) {  // a wrapped edge cell
      int C = p == 0 ? c0 - 1 : c0 + cells;
      C = C < 0 ? C + n : (C >= n ? C - n : C);
      dst[p == 0 ? PE - 1 : PE + cells] = C <= R ? src[C] : zero;
    } else {
      const int xs = c0 + (p - 1) * PE;  // the part's first cell
      int cnt = R + 1 - xs;              // its live cells
      cnt = cnt < 0 ? 0 : (cnt > PE ? PE : cnt);
      if constexpr (PE > 1) {
        const unsigned s = (unsigned)__cvta_generic_to_shared(dst + p * PE);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                     "l"(cnt ? src + xs : in), "r"(cnt * (int)sizeof(T))
                     : "memory");
      } else {
        dst[p] = cnt ? src[xs] : zero;
      }
    }
    p += dp;
    hr += dr;
    if (p >= parts) p -= parts, ++hr;
  }
}

// XW cells of T read or written as one access.
template <typename T, int XW>
struct alignas(XW * sizeof(T)) Legacy2DCells {
  T v[XW];
};

// One halo row's sums along x at a lane's XW cells p[0..XW-1]: R[i] =
// (h[i-1] + h[i]) + h[i+1] in the count's type.  The cell left of the
// first comes from the lane before (the last of its cells), or from
// shared memory where `lsm` (the first lane of a row); the cell right of
// the last likewise from the lane after, or from shared memory where
// `rsm`.  Every lane of the warp calls it together.
template <typename T, int XW>
static __device__ __forceinline__ void legacy_ca2d_row(const T* p, bool lsm, bool rsm,
                                                       typename Legacy2DCount<T>::A (&r)[XW],
                                                       T (&cells)[XW]) {
  using C = Legacy2DCount<T>;
  using A = typename C::A;
  const Legacy2DCells<T, XW> v = *reinterpret_cast<const Legacy2DCells<T, XW>*>(p);
  A h[XW];
#pragma unroll
  for (int i = 0; i < XW; ++i) {
    cells[i] = v.v[i];
    h[i] = C::widen(v.v[i]);
  }
  const A up = __shfl_up_sync(LEGACY2D_FULL, h[XW - 1], 1);
  const A down = __shfl_down_sync(LEGACY2D_FULL, h[0], 1);
  const A left = lsm ? C::widen(p[-1]) : up;
  const A right = rsm ? C::widen(p[XW]) : down;
#pragma unroll
  for (int i = 0; i < XW; ++i)
    r[i] = ((i == 0 ? left : h[i - 1]) + h[i]) + (i == XW - 1 ? right : h[i + 1]);
}

// The count and the rule over one warp's tile at element (gy0, gx0), its
// halo row 0 (tile row -1) at org with the tile's first cell at org[0],
// rows rs apart.  Work item it = (segment seg, chunk c of the row's
// pieces), the chunk fastest: a lane group of lr lanes takes the pieces xp
// = c * lr + li of every tile row and walks y over seg * ys .. (seg + 1) *
// ys - 1 with the row sums before, at and after its row in registers; the
// count is ((R[y-1] + R[y]) + R[y+1]) - centre.  Items go to the lane
// groups in turns; lanes without one still take part in the shuffles.
template <typename T, int XW>
static __device__ __forceinline__ void legacy_ca2d_count(T* __restrict__ out, const T* org,
                                                         int gy0, int gx0, int n, int rho,
                                                         int rs, int ys) {
  using C = Legacy2DCount<T>;
  using A = typename C::A;
  const int lane = threadIdx.x & 31;
  const int vr = rho / XW;  // pieces a tile row
  const int lr = vr < 32 ? vr : 32, groups = 32 / lr;
  const int gi = lane / lr, li = lane - gi * lr;
  const int chunks = (vr + 31) / 32;
  const int items = rho / ys * chunks;
  const T zero = Dt<T>::from_float(0.f), one = Dt<T>::from_float(1.f);
  for (int base = 0; base < items; base += groups) {
    int r = base + gi;
    bool act = gi < groups && r < items;
    if (!act) r = 0;
    const int seg = chunks == 1 ? r : r / chunks, c = r - seg * chunks;
    int xp = c * lr + li;
    act = act && xp < vr;
    if (!act) xp = 0;
    const bool lsm = li == 0, rsm = li == lr - 1 || xp == vr - 1;
    const int yb = seg * ys;
    const T* col = org + yb * rs + xp * XW;  // halo row yb holds tile row yb - 1
    A below[XW], at[XW], above[XW];
    T cen[XW], next[XW];
    legacy_ca2d_row<T, XW>(col, lsm, rsm, below, next);
    legacy_ca2d_row<T, XW>(col + rs, lsm, rsm, at, cen);
    const int gx = gx0 + xp * XW;
    for (int y = yb; y < yb + ys; ++y) {
      legacy_ca2d_row<T, XW>(col + (y - yb + 2) * rs, lsm, rsm, above, next);
      const int gy = gy0 + y;
      const int run = gy + 1 - gx;  // cells on the triangle from gx on
      if (act && run > 0) {
        Legacy2DCells<T, XW> res;
#pragma unroll
        for (int i = 0; i < XW; ++i) {
          const A neigh = ((below[i] + at[i]) + above[i]) - C::widen(cen[i]);
          const bool three = C::is(neigh, 3);
          const bool alive = (Dt<T>::eq(cen[i], 0) && three) ||
                             (Dt<T>::eq(cen[i], 1) && (C::is(neigh, 2) || three));
          res.v[i] = alive ? one : zero;
        }
        T* dst = out + (long long)gy * n + gx;
        if (run >= XW) {
          *reinterpret_cast<Legacy2DCells<T, XW>*>(dst) = res;
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

// The block's tiles at one wy in the state's type, PE cells a staging
// piece and XW a lane.  Where its tiles line up the block stages one halo:
// side by side, (rho+2) rows of cnt * rho cells at stride rs; stacked,
// (cnt * rho + 2) rows of rho cells at stride rs1; each warp counts its
// tile from it.  Otherwise each warp with a tile stages its own (rho+2)^2
// halo in one of `slots` slices (`slice` elements each), `slots` warps a
// round.  `dirty`: the block's shared memory holds an earlier grid row's
// halo, which its warps may still read.
template <typename T, int PE, int XW>
static __device__ __forceinline__ void legacy_ca2d_tiles(T* __restrict__ out,
                                                         const T* __restrict__ in, T* halo,
                                                         const Legacy2DBlock& b, bool dirty,
                                                         int n, int rho, int rs, int rs1, int ys,
                                                         int slice, int slots) {
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const bool shared = b.mode != LEGACY2D_ALONE;
  if (shared) {
    const bool stack = b.mode == LEGACY2D_STACK;
    const int stride = stack ? rs1 : rs;
    if (dirty) __syncthreads();
    legacy_ca2d_stage<T, PE>(halo, in, b.y0 * rho - 1, b.x0 * rho, n,
                             (stack ? b.cnt : 1) * rho + 2, (stack ? 1 : b.cnt) * rho, stride,
                             threadIdx.x, blockDim.x);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (warp < b.cnt)
      legacy_ca2d_count<T, XW>(out, halo + (stack ? warp * rho * stride : warp * rho) + PE,
                               b.yb * rho, b.xb * rho, n, rho, stride, ys);
    return;
  }
  const bool mine = (b.valid >> warp) & 1;
  const int rounds = (warps + slots - 1) / slots;
  for (int round = 0; round < rounds; ++round) {
    const int at = warp - round * slots;  // the warp's slice in this round
    if (dirty || round > 0) __syncthreads();  // the slices are free again
    if (mine && at >= 0 && at < slots) {
      T* mem = halo + at * slice;
      legacy_ca2d_stage<T, PE>(mem, in, b.yb * rho - 1, b.xb * rho, n, rho + 2, rho, rs1,
                               threadIdx.x & 31, 32);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncwarp();
      legacy_ca2d_count<T, XW>(out, mem + PE, b.yb * rho, b.xb * rho, n, rho, rs1, ys);
    }
  }
}

// One grid row at a time: every warp maps the block's grid points
// (legacy2d_block), a block with no tile goes on to its next row before
// any barrier, and the dtype is switched once into the typed tiles.  WIDE
// = 1 serves the states whose count takes more registers (int64's 64-bit
// sums, bfloat16 and float16 widened to float32) under a cap of
// LEGACY2D_CA_BLOCKS_WIDE blocks an SM; WIDE = 0 the others under
// LEGACY2D_CA_BLOCKS.
template <int WIDE>
__global__ void __launch_bounds__(LEGACY2D_WARPS * 32,
                                  WIDE ? LEGACY2D_CA_BLOCKS_WIDE : LEGACY2D_CA_BLOCKS)
legacy_ca2d_kernel(void* __restrict__ out, const void* __restrict__ in, int dtype, int kind,
                   int nb, int w, int h, int n, int rho, int vec, int rs, int rs1, int ys,
                   int slice, int slots) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  const int warps = blockDim.x >> 5;
  bool dirty = false;
  for (int wy = blockIdx.y; wy < h; wy += gridDim.y) {
    const Legacy2DBlock b = legacy2d_block(kind, blockIdx.x * warps, wy, w, nb, warps);
    if (!b.valid) continue;  // uniform in the block
#define LEGACY_CA2D_TILES(T)                                                               \
  if (vec)                                                                                 \
    legacy_ca2d_tiles<T, 16 / sizeof(T), sizeof(T) == 8 ? 2 : 4>(                          \
        static_cast<T*>(out), static_cast<const T*>(in), reinterpret_cast<T*>(s_raw), b,   \
        dirty, n, rho, rs, rs1, ys, slice, slots);                                         \
  else                                                                                     \
    legacy_ca2d_tiles<T, 1, 1>(static_cast<T*>(out), static_cast<const T*>(in),            \
                               reinterpret_cast<T*>(s_raw), b, dirty, n, rho, rs, rs1, ys, \
                               slice, slots)
    if constexpr (WIDE) {
      switch (dtype) {
        case SIMPLEX_I64: LEGACY_CA2D_TILES(long long); break;
        case SIMPLEX_BF16: LEGACY_CA2D_TILES(__nv_bfloat16); break;
        default: LEGACY_CA2D_TILES(__half); break;
      }
    } else {
      switch (dtype) {
        case SIMPLEX_I32: LEGACY_CA2D_TILES(int32_t); break;
        case SIMPLEX_F32: LEGACY_CA2D_TILES(float); break;
        case SIMPLEX_I8: LEGACY_CA2D_TILES(int8_t); break;
        case SIMPLEX_U8: LEGACY_CA2D_TILES(uint8_t); break;
        default: LEGACY_CA2D_TILES(int16_t); break;
      }
    }
#undef LEGACY_CA2D_TILES
    dirty = true;
  }
}

// Host: whether a CA dtype code takes the WIDE kernel.
static inline bool legacy_ca2d_wide(int dtype) {
  return dtype == SIMPLEX_I64 || dtype == SIMPLEX_BF16 || dtype == SIMPLEX_F16;
}

// Host: the row stride of a halo `tiles` tiles wide: a lead piece, the
// cells and a trail piece, two pieces more where the row would be a
// multiple of four pieces (so that rows read at once fall on distinct banks).
static int legacy_ca2d_row_stride(int rho, int tiles, int pe, int vec) {
  const int rs = tiles * rho + 2 * pe;
  return vec && (rs / pe) % 4 == 0 ? rs + 2 * pe : rs;
}

static size_t legacy2d_round16(size_t bytes) { return (bytes + 15) & ~(size_t)15; }

// Host: the block's layout, as kernels/legacy.py CA2DKernel.layout states
// it: the warps a block (LEGACY2D_WARPS, fewer where the side-by-side or
// stacked halo would pass LEGACY2D_CA_BUDGET), the side-by-side halo's
// row stride rs and a one-tile-wide halo's rs1 (stacked tiles and the
// slices; elements), ys (rows a lane walks), one slice's elements, the
// slices the block's memory holds (every warp's where they fit the
// budget) and that memory in bytes.  False where one slice does not fit.
static bool legacy_ca2d_layout(int rho, int size, int vec, int* warps, int* rs, int* rs1,
                               int* ys, int* slice, int* slots, size_t* smem) {
  const int pe = vec ? 16 / size : 1, xw = vec ? (size == 8 ? 2 : 4) : 1;
  *rs1 = legacy_ca2d_row_stride(rho, 1, pe, vec);
  const size_t one = legacy2d_round16((size_t)(rho + 2) * *rs1 * size);
  if (one > LEGACY2D_BLOCK_SMEM) return false;
  *slice = (int)(one / size);
  size_t halo = one;
  for (*warps = LEGACY2D_WARPS; *warps >= 1; --*warps) {
    *rs = legacy_ca2d_row_stride(rho, *warps, pe, vec);
    const size_t side = legacy2d_round16((size_t)(rho + 2) * *rs * size);
    const size_t stack = legacy2d_round16((size_t)(*warps * rho + 2) * *rs1 * size);
    halo = side > stack ? side : stack;
    if (*warps == 1 || halo <= LEGACY2D_CA_BUDGET) break;
  }
  if (*warps * one <= LEGACY2D_CA_BUDGET && *warps * one > halo) halo = *warps * one;
  *slots = (int)(halo / one) < *warps ? (int)(halo / one) : *warps;
  *smem = halo;
  const int vr = rho / xw, lr = vr < 32 ? vr : 32, chunks = (vr + 31) / 32;
  *ys = 1;
  for (int s = 1; s <= rho; ++s)
    if (rho % s == 0 && s * chunks >= 32 / lr) {
      *ys = rho / s;
      break;
    }
  return true;
}

// dtype: a code of dtypes.cuh that CA takes (kernels/policy.py
// DTYPE_CODES); vec: 1 for 16-byte pieces (kernels/legacy.py
// CA2DKernel.vector_access), 0 for single cells.  The grid is (ceil(w /
// warps), min(h, 65535)).
extern "C" int legacy_ca2d_launch(void* out, const void* in, int dtype, int kind, int nb,
                                  int n, int rho, int vec, void* stream) {
  int w, h, warps, rs, rs1, ys, slice, slots;
  size_t smem;
  if (!dt_ca_ok(dtype) || !legacy2d_tile_launch(kind, nb, n, rho, &w, &h))
    return (int)cudaErrorInvalidValue;
  const int size = dt_bytes(dtype);
  if (vec && ((((uintptr_t)out | (uintptr_t)in) & 15) || (rho * size) % 16))
    return (int)cudaErrorInvalidValue;
  if (!legacy_ca2d_layout(rho, size, vec, &warps, &rs, &rs1, &ys, &slice, &slots, &smem))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((w + warps - 1) / warps, h < 65535 ? h : 65535);
  cudaStream_t s = (cudaStream_t)stream;
#define LEGACY_CA2D(W)                                                                      \
  do {                                                                                      \
    if (smem > 48 * 1024) {                                                                 \
      cudaError_t e = cudaFuncSetAttribute(                                                 \
          legacy_ca2d_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);   \
      if (e != cudaSuccess) return (int)e;                                                  \
    }                                                                                       \
    legacy_ca2d_kernel<W><<<grid, warps * 32, smem, s>>>(out, in, dtype, kind, nb, w, h, n, \
                                                        rho, vec, rs, rs1, ys, slice, slots); \
  } while (0)
  if (legacy_ca2d_wide(dtype))
    LEGACY_CA2D(1);
  else
    LEGACY_CA2D(0);
#undef LEGACY_CA2D
  return (int)cudaGetLastError();
}
