// The frozen 2-D originals: MAP, ACCUM, EDM and CA over the paper's
// two-dimensional (w, h) grid.
//
// Replaces: the TPU kernels of repro/kernels/legacy.py map2d, accum2d,
// edm2d and ca2d (kernel table rows 7-10).  They are the independent
// differential baseline of the engine kernels (map.cu, accum.cu, edm.cu,
// ca.cu), so they share nothing with them beyond the m=2 map functions
// of the schedule subsystem: no linear-index simplex_map, no stencil
// table, no staging code.  Block (blockIdx.x, blockIdx.y) is the grid
// point (wx, wy) and goes through the map H: Z^2 -> Z^2 to its
// (column, row) tile, the paper's CUDA formulation.  gridDim.y is capped at 65535, so a block loops over
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

template <typename OutT>
static __device__ __forceinline__ void legacy_edm2d_body(OutT* __restrict__ out,
                                                         const float* __restrict__ p, int d,
                                                         int kind, int nb, int h, int n,
                                                         int rho, float* s_pts) {
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
      out[(long long)r * n + c] = Dt<OutT>::from_float(sqrtf(acc));
    }
  }
}

// out_dtype: the floating code of dtypes.cuh the output is stored in,
// switched once at the top into a body typed throughout.
__global__ void legacy_edm2d_kernel(void* __restrict__ out, int out_dtype,
                                    const float* __restrict__ p, int d, int kind, int nb, int h,
                                    int n, int rho) {
  extern __shared__ float s_pts[];
#define LEGACY_EDM2D_BODY(T) \
  legacy_edm2d_body<T>(static_cast<T*>(out), p, d, kind, nb, h, n, rho, s_pts)
  switch (out_dtype) {
    case SIMPLEX_F64: LEGACY_EDM2D_BODY(double); break;
    case SIMPLEX_BF16: LEGACY_EDM2D_BODY(__nv_bfloat16); break;
    case SIMPLEX_F16: LEGACY_EDM2D_BODY(__half); break;
    default: LEGACY_EDM2D_BODY(float); break;
  }
#undef LEGACY_EDM2D_BODY
}

// out_dtype: the floating code of dtypes.cuh the output is stored in; the
// points are float32.
extern "C" int legacy_edm2d_launch(void* out, int out_dtype, const void* p, int d, int kind,
                                   int nb, int n, int rho, void* stream) {
  dim3 grid;
  int h, threads;
  if (d < 1 || !dt_float_ok(out_dtype) ||
      !legacy2d_tile_launch(kind, nb, n, rho, &grid, &h, &threads))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * (size_t)rho * (d + 1);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        legacy_edm2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  legacy_edm2d_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      out, out_dtype, (const float*)p, d, kind, nb, h, n, rho);
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
