// CA: one B3/S23 Game-of-Life step with 3^m - 1 neighbours on int32 0/1
// state, from an input buffer into a separate output buffer that starts
// as a copy of the input (off-domain cells keep their input).
//
// Replaces: the TPU kernel of repro/kernels/engine.py _launch_domain
// with CABody and _assemble_halo (kernel table row 4), which fetched 3^m
// shifted tiles per step and stepped the state in place.  In place is
// sound on the TPU only because its grid runs in order over an aliased
// copy; blocks here run in no order, so this kernel reads only the
// input and writes only the output.
//
// Bound on the card: memory — each domain cell read once and written
// once, 2 * V * 4 bytes at 3.35 TB/s; the halo re-reads (rho+2)^m/rho^m
// of the input, mostly from L2.  Design: one block per schedule step;
// thread 0 evaluates the map and the block shares it; the block stages
// a (rho+2)^m halo from the input in shared memory, each halo
// cell masked as _assemble_halo masks it (m=2: periodic, wrapped mod n
// and masked by the domain of its wrapped position; m >= 3: free, 0
// outside [0, n)^m or off the domain), then each tile cell sums its
// neighbours from shared memory through a table of the 3^m stencil's
// halo offsets, built once per block, and writes if it lies in the
// domain.  Templated on m, so the index loops unroll into registers.
#include "simplex_maps.cuh"

template <int M>
__global__ void simplex_ca_kernel(int* __restrict__ out, const int* __restrict__ in,
                                  SimplexMap map, int n, int rho, int shift, int periodic) {
  extern __shared__ int smem_ca[];
  __shared__ int s_blk[SIMPLEX_MAX_M + 1];
  if (!simplex_block_shared(map, s_blk)) return;
  int blk[M];
#pragma unroll
  for (int j = 0; j < M; ++j) blk[j] = s_blk[j];
  const int H = rho + 2;
  const int hsize = simplex_ipow<M>(H);
  constexpr int nstencil = M == 2 ? 9 : M == 3 ? 27 : M == 4 ? 81 : M == 5 ? 243
                         : M == 6 ? 729 : M == 7 ? 2187 : 6561;
  int* halo = smem_ca;               // [(rho+2)^M]
  int* stencil = smem_ca + hsize;    // [3^M] halo offsets of the neighbours
  for (int t = threadIdx.x; t < nstencil; t += blockDim.x) {
    int q = t, off = 0, stride = 1;
#pragma unroll
    for (int j = M - 1; j >= 0; --j) {
      off += (q % 3 - 1) * stride;
      q /= 3;
      stride *= H;
    }
    stencil[t] = off;
  }
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
    halo[e] = ok ? in[simplex_offset<M>(g, n)] : 0;
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
    int neigh = 0;
    for (int t = 0; t < nstencil; ++t) neigh += halo[centre + stencil[t]];
    const int c = halo[centre];
    neigh -= c;  // the stencil includes the centre
    int alive = (c == 0 && neigh == 3) || (c == 1 && (neigh == 2 || neigh == 3));
    out[simplex_offset<M>(g, n)] = alive;
  }
}

extern "C" int simplex_ca_launch(void* out, const void* in, int periodic,
                                 const long long* header, const void* data, int n,
                                 int rho, void* stream) {
  SimplexMap M = simplex_map_from_header(header, (const int*)data);
  if (!simplex_map_ok(M) || rho < 1 || n % rho) return (int)cudaErrorInvalidValue;
  if (M.steps == 0) return 0;
  size_t hsize = 1, nstencil = 1;
  int tile = 1;
  for (int j = 0; j < M.m; ++j) {
    hsize *= rho + 2;
    nstencil *= 3;
    tile *= rho;
  }
  const size_t smem = sizeof(int) * (hsize + nstencil);
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
    simplex_ca_kernel<MM><<<M.steps, threads, smem, s>>>(                        \
        (int*)out, (const int*)in, M, n, rho, shift, periodic);                  \
  } while (0)
  SIMPLEX_DISPATCH_M(M.m, SIMPLEX_CA)
#undef SIMPLEX_CA
  return (int)cudaGetLastError();
}
