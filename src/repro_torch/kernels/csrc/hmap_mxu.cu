// The paper's §7.1 block map on the tensor cores: D = A x B + C (Eq. 32).
//
// Replaces: the TPU kernel of repro/kernels/hmap_mxu.py hmap2_coords_mxu
// (kernel table row 6), one (8, 8) x (8, 128) float32 MXU product per
// 128 blocks.  The H map (Eq. 16) is affine in (wx, wy, qb):
//
//     x = rho * (wx + qb),   y = rho * (wy + 2 qb),
//     b = pow2_floor(max(wy, 1)),   qb = floor(wx / b) * b,
//
// so A = rho * [[1, 0, 1, 0], [0, 1, 2, 0], 0, ...] holds the map's
// constants, each column of B one block's (wx, wy, qb, 0), and rows 0
// and 1 of D are the blocks' element origins x and y.  C, the
// intra-block offset of thread (0, 0), is zero, as in the reference.
//
// The product has to come out exact.  TF32 keeps 10 mantissa bits and
// rounds coordinates above 2^11, and the reference's float32 rounds above
// 2^24, so this is the FP64 MMA mma.sync.m8n8k4.row.col.f64 (sm_80 and
// later): its K = 4 takes (wx, wy, qb, 0) exactly, and every product and
// sum of int32 values is exact in float64.  Fragments (PTX ISA, "Matrix
// Fragments for mma.m8n8k4 with .f64"; CUTLASS's arch/mma_sm80.h wraps the
// same instruction): lane l holds A[l / 4][l % 4], B[l % 4][l / 4], and
// D[l / 4][2 (l % 4) + i] for i = 0, 1.  One warp takes 128 blocks in 16
// MMAs of 8 blocks each.  b and qb are integer work on the CUDA cores, as
// the reference does them on the scalar unit; qb = wx & ~(b - 1) is the
// floor division for any int32 wx (b is a power of two).  D converts to
// int64 exactly and then to int32 by wrap-around, as the plain version's
// casts do.
//
// Bound on the card: memory.  Each block reads 8 bytes and writes 8, 16
// bytes at 3.35 TB/s; the 16 MMAs of a warp are 8192 float64 operations
// per 128 blocks, far below the FP64 tensor rate.  Design: 8 warps a
// block, one group of 128 blocks a warp; the four lanes of a B column
// read the same 8 bytes, and lanes 0-7 write D's rows 0 and 1.
#include <cuda_runtime.h>
#include <limits.h>

static __device__ __forceinline__ void hmap_mxu_dmma(double a, double b, double* d0,
                                                     double* d1) {
  const double c = 0.0;
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%4, %5};\n"
      : "=d"(*d0), "=d"(*d1)
      : "d"(a), "d"(b), "d"(c), "d"(c));
}

__global__ void hmap2_coords_mxu_kernel(int* __restrict__ out, const int2* __restrict__ wxy,
                                        long long groups, int rho) {
  const long long group = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (group >= groups) return;  // uniform in the warp
  const int lane = threadIdx.x & 31;
  const int row = lane >> 2;  // A's row; B's column (the block within the MMA)
  const int k = lane & 3;     // A's column; B's row
  double a = 0.0;
  if (row == 0 && (k == 0 || k == 2)) a = rho;  // x <- wx + qb
  if (row == 1 && k == 1) a = rho;              // y <- wy
  if (row == 1 && k == 2) a = 2.0 * rho;        //      + 2 qb
  const long long base = group * 128;
  for (int i = 0; i < 16; ++i) {
    const int2 w = wxy[base + i * 8 + row];
    const int b = 1 << (31 - __clz(w.y > 1 ? w.y : 1));
    const int qb = w.x & ~(b - 1);
    const double bv = k == 0 ? (double)w.x : k == 1 ? (double)w.y : k == 2 ? (double)qb : 0.0;
    double d0, d1;
    hmap_mxu_dmma(a, bv, &d0, &d1);
    if (row < 2) {  // D rows 0 (x) and 1 (y): blocks 2k and 2k + 1 of this MMA
      int* o = out + (base + i * 8 + 2 * k) * 2 + row;
      o[0] = (int)__double2ll_rn(d0);
      o[2] = (int)__double2ll_rn(d1);
    }
  }
}

// out, wxy: (t, 2) int32, t a multiple of 128.
extern "C" int hmap2_coords_mxu_launch(void* out, const void* wxy, long long t, int rho,
                                       void* stream) {
  if (t < 0 || t % 128) return (int)cudaErrorInvalidValue;
  if (t == 0) return 0;
  const long long groups = t / 128;
  const int warps = 8;
  const long long blocks = (groups + warps - 1) / warps;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  hmap2_coords_mxu_kernel<<<(unsigned)blocks, warps * 32, 0, (cudaStream_t)stream>>>(
      (int*)out, (const int2*)wxy, groups, rho);
  return (int)cudaGetLastError();
}
