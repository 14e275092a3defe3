// The paper's §7.1 block map on the tensor cores: D = A x B + C (Eq. 32).
//
// Replaces: the TPU kernel of repro/kernels/hmap_mxu.py hmap2_coords_mxu
// (kernel table row 6), one (8, 8) x (8, 128) float32 MXU product per
// 128 blocks.  The H map (Eq. 16) is affine in (wx, wy, qb):
//
//     x = rho * (wx + qb),   y = rho * (wy + 2 qb),
//     b = pow2_floor(max(wy, 1)),   qb = floor(wx / b) * b,
//
// so each block's origin is one row of a product.  The blocks are A's
// rows and the map's constants B: A[r] = (wx, wy, qb, 0) of block r,
// B = rho * [[1, 0], [0, 1], [1, 2], [0, 0]] padded to 4 x 8, and row r of
// D = A x B holds (x, y) of block r in its columns 0 and 1.  C, the
// intra-block offset of thread (0, 0), is zero, as in the reference.
//
// The product has to come out exact.  TF32 keeps 10 mantissa bits and
// rounds coordinates above 2^11, and the reference's float32 rounds above
// 2^24, so this is the FP64 MMA mma.sync.m8n8k4.row.col.f64 (sm_80 and
// later): its K = 4 takes (wx, wy, qb, 0) exactly, and every product and
// sum of int32 values is exact in float64.  Fragments (PTX ISA, "Matrix
// Fragments for mma.m8n8k4 with .f64"; CUTLASS's arch/mma_sm80.h wraps the
// same instruction): lane l holds A[l / 4][l % 4], B[l % 4][l / 4], and
// D[l / 4][2 (l % 4) + i] for i = 0, 1, so lane 4r ends with block r's
// (x, y) whole.  b and qb are integer work on the CUDA cores, as the
// reference does them on the scalar unit; qb = wx & ~(b - 1) is the floor
// division for any int32 wx (b is a power of two).  D converts to int64
// exactly and then to int32 by wrap-around, as the plain version's casts
// do.
//
// Bound on the card: memory.  Each block reads 8 bytes and writes 8, 16
// bytes at 3.35 TB/s; an MMA of 8 blocks is 512 float64 operations, far
// below the FP64 tensor rate.  The first port (blocks as B's columns) ran
// at 46 % of that bound: few bytes in flight, and x and y of a block
// stored as 4-byte scalars by two lanes, each sector written in two
// passes.  Design: 8 warps a block, a warp per group of 128 blocks, 16
// MMAs of 8.  Lane l loads block l / 4 of each MMA (the four lanes of a
// block on one 8-byte address, 64 distinct bytes a load instruction), and
// lane 4r stores block r's (x, y) as one 8-byte piece, so the 8 storing
// lanes of an MMA write 64 contiguous bytes, two whole sectors.  The 16
// MMAs are unrolled and their loads independent of the stores
// (__restrict__), so the compiler keeps about 8 loads a lane in flight
// ahead of the MMAs; kept in a loop, one load a lane in flight, the same
// product ran at the first port's time.  8-byte accesses take any (T, 2)
// int32 view, also one 8 bytes off a 16-byte boundary such as wxy[1:], on
// the one path.  On the card this runs within a few percent of one copy_
// of the same bytes; a persistent grid, and a ring of 16-byte cp.async
// copies through shared memory with 16-byte stores, each ran about 10 %
// slower (scripts/legacy_variants.py).
#include <cuda_runtime.h>
#include <limits.h>

#define HMAP_MXU_WARPS 8  // warps a block, a group of 128 blocks each

static __device__ __forceinline__ void hmap_mxu_dmma(double a, double b, double* d0,
                                                     double* d1) {
  const double c = 0.0;
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%4, %5};\n"
      : "=d"(*d0), "=d"(*d1)
      : "d"(a), "d"(b), "d"(c), "d"(c));
}

__global__ void __launch_bounds__(HMAP_MXU_WARPS * 32)
    hmap2_coords_mxu_kernel(int2* __restrict__ out, const int2* __restrict__ wxy,
                            long long groups, int rho) {
  const long long group = (long long)blockIdx.x * HMAP_MXU_WARPS + (threadIdx.x >> 5);
  if (group >= groups) return;  // uniform in the warp
  const int lane = threadIdx.x & 31;
  const int r = lane >> 2;  // A's row (the block within the MMA); B's column
  const int k = lane & 3;   // A's column; B's row
  double b = 0.0;
  if (r == 0 && (k == 0 || k == 2)) b = rho;  // x <- wx + qb
  if (r == 1 && k == 1) b = rho;              // y <- wy
  if (r == 1 && k == 2) b = 2.0 * rho;        //      + 2 qb
  const long long base = group * 128 + r;     // block r of the group's first MMA
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int2 w = wxy[base + 8 * j];
    const int bw = 1 << (31 - __clz(w.y > 1 ? w.y : 1));
    const int qb = w.x & ~(bw - 1);
    const int v = k == 0 ? w.x : k == 1 ? w.y : k == 2 ? qb : 0;
    double d0, d1;
    hmap_mxu_dmma((double)v, b, &d0, &d1);
    if (k == 0)  // D[r][0] and D[r][1]: block r's (x, y)
      out[base + 8 * j] = make_int2((int)__double2ll_rn(d0), (int)__double2ll_rn(d1));
  }
}

// out, wxy: (t, 2) int32, t a multiple of 128, each aligned to 8 bytes.
extern "C" int hmap2_coords_mxu_launch(void* out, const void* wxy, long long t, int rho,
                                       void* stream) {
  if (t < 0 || t % 128) return (int)cudaErrorInvalidValue;
  if ((size_t)out % 8 || (size_t)wxy % 8) return (int)cudaErrorMisalignedAddress;
  if (t == 0) return 0;
  const long long groups = t / 128;
  const long long blocks = (groups + HMAP_MXU_WARPS - 1) / HMAP_MXU_WARPS;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;  // past 2^41 blocks
  int2* o = (int2*)out;
  const int2* w = (const int2*)wxy;
  cudaStream_t st = (cudaStream_t)stream;
  hmap2_coords_mxu_kernel<<<(unsigned)blocks, HMAP_MXU_WARPS * 32, 0, st>>>(o, w, groups, rho);
  return (int)cudaGetLastError();
}
