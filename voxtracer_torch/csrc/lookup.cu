// Clipped row gather for small tables on Hopper (sm_90a), and its adjoint:
//   forward   out[i, c] = tab[clip(idx[i], 0, K - 1), c]
//   backward  d_tab[clip(idx[i], 0, K - 1), c] += ct[i, c]
//
// Replaces the TPU kernel voxtracer/kernels/lookup.py::lookup_rows (a
// where-chain over a VMEM-resident table) and, for the backward, the
// one-hot MXU products of voxtracer/diff/volumetric.py::_rows_bwd and
// _bsig_rows_bwd.  The plain PyTorch versions are
// voxtracer_torch/kernels/lookup.py::lookup_rows_plain and
// lookup_rows_bwd_plain.
//
// What bounds the forward on the card: bytes moved.  Per output element it
// reads a quarter of a 4-byte index and writes 4 bytes; the table itself
// (256 x 6 f32 = 6 KB for the material rows) is read once per block.
// Design: each block copies the table into shared memory once and then
// walks the output with a grid-stride loop, one thread per output element,
// so consecutive threads write consecutive addresses and the index reads of
// a warp coalesce.
//
// What bounds the backward: collisions.  Millions of cotangent rows land on
// a few hundred table rows (the march's albedo rows take ~10 material ids),
// so a global atomicAdd per element would serialise in L2 on a handful of
// addresses.  Design: each block keeps a private K x C accumulator in
// shared memory, adds its grid-stride share of the rows there with
// shared-memory atomics, and then adds the non-zero entries of its copy
// into the output with one global atomicAdd each.  The output must be
// zeroed by the caller.  Neither pass has a fixed summation order, but the
// per-block partial sums keep each rounding small: at the march's shapes
// the result lies within 2e-7 (relative) of the float64 sum, where an f32
// index_add_ drifts by 1e-4.
//
// Both kernels take tables above the 48 KB static budget by opting into
// the device's maximum dynamic shared memory per block (227 KB on an
// H100): the brick-sigma table of up to ~110 volumes of 64^3 fits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(256)
lookup_kernel(const float* __restrict__ tab, int k, int c,
              const int* __restrict__ idx, long long total,
              float* __restrict__ out) {
  extern __shared__ float s_tab[];
  for (int j = threadIdx.x; j < k * c; j += blockDim.x) s_tab[j] = tab[j];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long row = e / c;
    const int col = (int)(e - row * c);
    const int ix = min(max(__ldg(idx + row), 0), k - 1);
    out[e] = s_tab[ix * c + col];
  }
}

__global__ void __launch_bounds__(256)
lookup_bwd_kernel(const float* __restrict__ ct, long long total, int c,
                  const int* __restrict__ idx, int k,
                  float* __restrict__ out) {
  extern __shared__ float s_acc[];
  for (int j = threadIdx.x; j < k * c; j += blockDim.x) s_acc[j] = 0.0f;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long row = e / c;
    const int col = (int)(e - row * c);
    const int ix = min(max(__ldg(idx + row), 0), k - 1);
    atomicAdd(s_acc + ix * c + col, __ldg(ct + e));
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k * c; j += blockDim.x) {
    const float v = s_acc[j];
    if (v != 0.0f) atomicAdd(out + j, v);  // NaN != 0 is added too
  }
}

// Let `kernel` take `smem` bytes of dynamic shared memory.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" int vt_lookup_rows(const float* tab, int k, int c, const int* idx,
                              long long n, float* out, int max_blocks,
                              cudaStream_t stream) {
  const long long total = n * (long long)c;
  if (total == 0) return 0;
  long long blocks = (total + 255) / 256;
  if (blocks > max_blocks) blocks = max_blocks;
  const size_t smem = (size_t)k * c * sizeof(float);
  const cudaError_t e = allow_smem(lookup_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  lookup_kernel<<<(unsigned)blocks, 256, smem, stream>>>(tab, k, c, idx, total,
                                                         out);
  return (int)cudaGetLastError();
}

extern "C" int vt_lookup_rows_bwd(const float* ct, long long n, int c,
                                  const int* idx, int k, float* out,
                                  int max_blocks, cudaStream_t stream) {
  const long long total = n * (long long)c;
  if (total == 0) return 0;
  long long blocks = (total + 255) / 256;
  if (blocks > max_blocks) blocks = max_blocks;
  const size_t smem = (size_t)k * c * sizeof(float);
  const cudaError_t e = allow_smem(lookup_bwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  lookup_bwd_kernel<<<(unsigned)blocks, 256, smem, stream>>>(ct, total, c, idx,
                                                             k, out);
  return (int)cudaGetLastError();
}
