// CA: one B3/S23 Game-of-Life step with 3^m - 1 neighbours on a 0/1
// state of any dtype CA takes (dtypes.cuh), from an input buffer into a
// separate output buffer that starts as a copy of the input (off-domain
// cells keep their input).
//
// Replaces: the TPU kernel of repro/kernels/engine.py _launch_domain
// with CABody and _assemble_halo (kernel table row 4), which fetched 3^m
// shifted tiles per step and stepped the state in place.  In place is
// sound on the TPU only because its grid runs in order over an aliased
// copy; blocks here run in no order, so this kernel reads only the
// input and writes only the output.
//
// Bound on the card: memory — each domain cell read once and written
// once, 2 * V * sizeof(T) bytes at 3.35 TB/s; the halo re-reads (rho+2)^m/rho^m
// of the input, mostly from L2.  Design: one block per schedule step;
// thread 0 evaluates the map and the block shares it; the block stages
// a (rho+2)^m halo from the input in shared memory, each halo
// cell masked as _assemble_halo masks it (m=2: periodic, wrapped mod n
// and masked by the domain of its wrapped position; m >= 3: free, 0
// outside [0, n)^m or off the domain), then each tile cell sums its
// neighbours from shared memory through a table of the 3^m - 1 stencil
// offsets (the centre left out), built once per block, and writes if it
// lies in the domain.  The neighbour count runs in the state's own type,
// as the reference's does (Dt<T>: integers wrap, 16-bit floats round
// after each add), so a state of any values gives the reference's
// answer, and a 0/1 state gives exact counts in every type.  The kernel
// is templated on m, so the index loops unroll into registers, and the
// tile's work on the element type, chosen by a run-time code after the
// block's map (one kernel per m, not per (m, type): the inlined general
// map is what makes a kernel slow to compile).
#include "dtypes.cuh"
#include "simplex_maps.cuh"

// Shared memory: the (rho+2)^m halo of the state's type, rounded up to 4
// bytes, then the int stencil offsets.
static __host__ __device__ __forceinline__ size_t simplex_ca_halo_bytes(size_t hsize,
                                                                       size_t elem) {
  return (hsize * elem + 3) & ~(size_t)3;
}

// One tile of block blk in the state's type T: stage the halo, count each
// domain cell's neighbours in T, write the rule's 0/1 in T.
template <int M, typename T>
static __device__ __forceinline__ void simplex_ca_tile(T* __restrict__ out,
                                                       const T* __restrict__ in,
                                                       const int* blk, int n, int rho,
                                                       int shift, int periodic,
                                                       unsigned char* smem) {
  const int H = rho + 2;
  const int hsize = simplex_ipow<M>(H);
  constexpr int nstencil = (M == 2 ? 9 : M == 3 ? 27 : M == 4 ? 81 : M == 5 ? 243
                            : M == 6 ? 729 : M == 7 ? 2187 : 6561) - 1;
  T* halo = reinterpret_cast<T*>(smem);  // [(rho+2)^M]
  int* stencil =                         // [3^M - 1] neighbour offsets
      reinterpret_cast<int*>(smem + simplex_ca_halo_bytes(hsize, sizeof(T)));
  for (int t = threadIdx.x; t < nstencil; t += blockDim.x) {
    int q = t < nstencil / 2 ? t : t + 1;  // skip the centre, index (3^M - 1) / 2
    int off = 0, stride = 1;
#pragma unroll
    for (int j = M - 1; j >= 0; --j) {
      off += (q % 3 - 1) * stride;
      q /= 3;
      stride *= H;
    }
    stencil[t] = off;
  }
  const T zero = Dt<T>::from_float(0.f);
  for (int e = threadIdx.x; e < hsize; e += blockDim.x) {
    int g[M];
    int r = e;
    bool ok = true;
#pragma unroll
    for (int j = M - 1; j >= 0; --j) {
      int v = blk[j] * rho - 1 + r % H;
      r /= H;
      if (periodic) v = (v + n) % n;
      else if (v < 0 || v >= n) ok = false;
      g[j] = v;
    }
    ok = ok && simplex_in_domain<M>(g, n);
    halo[e] = ok ? in[simplex_offset<M>(g, n)] : zero;
  }
  __syncthreads();
  const int tile = simplex_ipow<M>(rho);
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    int g[M];
    int r = e, centre = 0, stride = 1;
#pragma unroll
    for (int j = M - 1; j >= 0; --j) {
      int l = simplex_split(r, rho, shift);
      g[j] = blk[j] * rho + l;
      centre += (l + 1) * stride;
      stride *= H;
    }
    if (!simplex_in_domain<M>(g, n)) continue;
    T neigh = zero;
    for (int t = 0; t < nstencil; ++t) neigh = Dt<T>::add(neigh, halo[centre + stencil[t]]);
    const T c = halo[centre];
    const bool three = Dt<T>::eq(neigh, 3);
    const bool alive = (Dt<T>::eq(c, 0) && three) ||
                       (Dt<T>::eq(c, 1) && (Dt<T>::eq(neigh, 2) || three));
    out[simplex_offset<M>(g, n)] = Dt<T>::from_float(alive ? 1.f : 0.f);
  }
}

template <int M>
__global__ void simplex_ca_kernel(void* __restrict__ out, const void* __restrict__ in,
                                  int dtype, SimplexMap map, int n, int rho, int shift,
                                  int periodic) {
  extern __shared__ __align__(16) unsigned char smem_ca[];
  __shared__ int s_blk[SIMPLEX_MAX_M + 1];
  if (!simplex_block_shared(map, s_blk)) return;
  int blk[M];
#pragma unroll
  for (int j = 0; j < M; ++j) blk[j] = s_blk[j];
#define SIMPLEX_CA_TILE(T)                                                                \
  simplex_ca_tile<M, T>(static_cast<T*>(out), static_cast<const T*>(in), blk, n, rho, shift, \
                        periodic, smem_ca)
  SIMPLEX_SWITCH_CA_DTYPE(dtype, SIMPLEX_CA_TILE)
#undef SIMPLEX_CA_TILE
}

// dtype: a code of dtypes.cuh that CA takes (kernels/policy.py DTYPE_CODES).
extern "C" int simplex_ca_launch(void* out, const void* in, int dtype, int periodic,
                                 const long long* header, const void* data, int n,
                                 int rho, void* stream) {
  SimplexMap M = simplex_map_from_header(header, (const int*)data);
  if (!simplex_map_ok(M) || rho < 1 || n % rho || !dt_ca_ok(dtype))
    return (int)cudaErrorInvalidValue;
  if (M.steps == 0) return 0;
  size_t hsize = 1, nstencil = 1;
  int tile = 1;
  for (int j = 0; j < M.m; ++j) {
    hsize *= rho + 2;
    nstencil *= 3;
    tile *= rho;
  }
  const size_t smem = simplex_ca_halo_bytes(hsize, dt_bytes(dtype)) +
                      sizeof(int) * (nstencil - 1);
  int threads = tile < 1024 ? tile : 1024;
  if (threads < 32) threads = 32;
  const int shift = simplex_rho_shift(rho);
  cudaStream_t s = (cudaStream_t)stream;
#define SIMPLEX_CA(MM)                                                           \
  do {                                                                           \
    if (smem > 48 * 1024) {                                                      \
      cudaError_t err = cudaFuncSetAttribute(                                    \
          simplex_ca_kernel<MM>, cudaFuncAttributeMaxDynamicSharedMemorySize,    \
          (int)smem);                                                            \
      if (err != cudaSuccess) return (int)err;                                   \
    }                                                                            \
    simplex_ca_kernel<MM><<<M.steps, threads, smem, s>>>(out, in, dtype, M, n, rho, \
                                                         shift, periodic);      \
  } while (0)
  SIMPLEX_DISPATCH_M(M.m, SIMPLEX_CA)
#undef SIMPLEX_CA
  return (int)cudaGetLastError();
}
