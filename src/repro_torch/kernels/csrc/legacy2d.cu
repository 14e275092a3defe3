// The frozen 2-D originals: MAP, ACCUM, EDM and CA over the paper's
// two-dimensional (w, h) grid.
//
// Replaces: the TPU kernels of repro/kernels/legacy.py map2d, accum2d,
// edm2d and ca2d (kernel table rows 7-10).  They are the independent
// differential baseline of the engine kernels (map.cu, accum.cu, edm.cu,
// ca.cu), so they share nothing with them beyond the m=2 map functions
// of the schedule subsystem: no linear-index simplex_map, no
// simplex_block_shared, no stencil table, no staging code.  Block
// (blockIdx.x, blockIdx.y) is the grid point (wx, wy) and goes through
// the map H: Z^2 -> Z^2 to its (column, row) tile, the paper's CUDA
// formulation.  gridDim.y is capped at 65535, so a block loops over
// wy = blockIdx.y, blockIdx.y + gridDim.y, ... (the hmap/rb grid is
// (nb/2, nb+1) and nb reaches 65536 at rho = 1).
//
// On the TPU every grid step flushed its block back through input/output
// aliasing; here an invalid bb step writes nothing.  ACCUM updates the
// buffer it is given (the wrapper passes a copy), EDM writes the domain
// cells of a zero-seeded output, and CA reads one buffer and writes
// another that starts as a copy of the input, because blocks run in no
// order.
//
// Bounds on the card: MAP writes 12 bytes per step, ACCUM and CA read and
// write each domain cell once (memory); EDM reads 2*rho*d floats per tile
// and does d subtract-multiply-adds per domain cell (operations at large
// d).  Design: one block per grid point, rho*rho elements per tile with
// the column fastest so neighbouring threads touch neighbouring
// addresses, a loop when rho*rho exceeds the block's 1024 threads; EDM
// stages its row and column point blocks, rows padded to d+1 floats so
// that threads of one warp read distinct banks; CA stages the
// (rho+2)^2 periodic halo, each cell masked by its own wrapped
// position.  Element offsets are int64 (n = 65536 is a 16 GiB array).
#include <limits.h>

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
__global__ void legacy_accum2d_kernel(T* __restrict__ x, int kind, int nb, int h, int n,
                                      int rho) {
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
        x[off] = x[off] + (T)1;
      }
    }
  }
}

template <typename T>
static int legacy_accum2d_run(T* x, int kind, int nb, int n, int rho, cudaStream_t s) {
  dim3 grid;
  int h, threads;
  if (!legacy2d_tile_launch(kind, nb, n, rho, &grid, &h, &threads))
    return (int)cudaErrorInvalidValue;
  legacy_accum2d_kernel<T><<<grid, threads, 0, s>>>(x, kind, nb, h, n, rho);
  return (int)cudaGetLastError();
}

// dtype: 0 int32, 1 int64, 2 float32, 3 float64.
extern "C" int legacy_accum2d_launch(void* x, int dtype, int kind, int nb, int n, int rho,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return legacy_accum2d_run((int*)x, kind, nb, n, rho, s);
    case 1: return legacy_accum2d_run((long long*)x, kind, nb, n, rho, s);
    case 2: return legacy_accum2d_run((float*)x, kind, nb, n, rho, s);
    case 3: return legacy_accum2d_run((double*)x, kind, nb, n, rho, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// EDM: out[r, c] = sqrt(sum_k (p[r, k] - p[c, k])^2) where c <= r.
// ---------------------------------------------------------------------------

__global__ void legacy_edm2d_kernel(float* __restrict__ out, const float* __restrict__ p,
                                    int d, int kind, int nb, int h, int n, int rho) {
  extern __shared__ float s_pts[];
  const int ld = d + 1;
  float* s_row = s_pts;              // (rho, d+1): points of the row block
  float* s_col = s_pts + rho * ld;   // (rho, d+1): points of the column block
  const int wx = blockIdx.x;
  const int tile = rho * rho;
  for (int wy = blockIdx.y; wy < h; wy += gridDim.y) {
    int xb, yb;
    if (!legacy2d_map(kind, wx, wy, nb, &xb, &yb)) continue;  // uniform in the block
    __syncthreads();  // the last tile's reads of shared memory are done
    for (int e = threadIdx.x; e < rho * d; e += blockDim.x) {
      const int i = e / d;
      const int k = e - i * d;
      s_row[i * ld + k] = p[(long long)(yb * rho + i) * d + k];
      s_col[i * ld + k] = p[(long long)(xb * rho + i) * d + k];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < tile; e += blockDim.x) {
      const int i = e / rho;
      const int j = e - i * rho;
      const int r = yb * rho + i;
      const int c = xb * rho + j;
      if (c > r) continue;
      const float* a = s_row + i * ld;
      const float* b = s_col + j * ld;
      float acc = 0.f;
      for (int k = 0; k < d; ++k) {
        const float t = a[k] - b[k];
        acc += t * t;
      }
      out[(long long)r * n + c] = sqrtf(acc);
    }
  }
}

extern "C" int legacy_edm2d_launch(void* out, const void* p, int d, int kind, int nb,
                                   int n, int rho, void* stream) {
  dim3 grid;
  int h, threads;
  if (d < 1 || !legacy2d_tile_launch(kind, nb, n, rho, &grid, &h, &threads))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * (size_t)rho * (d + 1);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        legacy_edm2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  legacy_edm2d_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (float*)out, (const float*)p, d, kind, nb, h, n, rho);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// CA: one B3/S23 step on the triangle of a periodic square, in -> out.
// ---------------------------------------------------------------------------

__global__ void legacy_ca2d_kernel(int* __restrict__ out, const int* __restrict__ in,
                                   int kind, int nb, int h, int n, int rho) {
  extern __shared__ int s_halo[];  // (rho+2)^2, origin one cell up and left of the tile
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
      s_halo[e] = C <= R ? in[(long long)R * n + C] : 0;  // off the triangle: dead
    }
    __syncthreads();
    for (int e = threadIdx.x; e < tile; e += blockDim.x) {
      const int i = e / rho;
      const int j = e - i * rho;
      const int r = yb * rho + i;
      const int c = xb * rho + j;
      if (c > r) continue;
      const int* q = s_halo + (i + 1) * hs + (j + 1);
      const int centre = q[0];
      const int neigh = q[-hs - 1] + q[-hs] + q[-hs + 1] + q[-1] + q[1] + q[hs - 1] +
                        q[hs] + q[hs + 1];
      const bool alive = (centre == 0 && neigh == 3) ||
                         (centre == 1 && (neigh == 2 || neigh == 3));
      out[(long long)r * n + c] = alive;
    }
  }
}

extern "C" int legacy_ca2d_launch(void* out, const void* in, int kind, int nb, int n,
                                  int rho, void* stream) {
  dim3 grid;
  int h, threads;
  if (!legacy2d_tile_launch(kind, nb, n, rho, &grid, &h, &threads))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * (size_t)(rho + 2) * (rho + 2);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        legacy_ca2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  legacy_ca2d_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (int*)out, (const int*)in, kind, nb, h, n, rho);
  return (int)cudaGetLastError();
}
