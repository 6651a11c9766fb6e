// Clipped row gather for small tables on Hopper (sm_90a):
//   out[i, c] = tab[clip(idx[i], 0, K - 1), c].
//
// Replaces the TPU kernel voxtracer/kernels/lookup.py::lookup_rows (a
// where-chain over a VMEM-resident table).  The plain PyTorch version is
// voxtracer_torch/kernels/lookup.py::lookup_rows_plain.
//
// What bounds it on the card: bytes moved.  Per output element it reads
// a quarter of a 4-byte index and writes 4 bytes; the table itself
// (256 x 6 f32 = 6 KB for the material rows) is read once per block.
//
// What the design does about it: each block copies the table into shared
// memory once and then walks the output with a grid-stride loop, one
// thread per output element, so consecutive threads write consecutive
// addresses and the index reads of a warp coalesce.  Fusing this lookup
// into the traversal epilogue, which would drop the index round trip
// through device memory, is later work.

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

}  // namespace

extern "C" int vt_lookup_rows(const float* tab, int k, int c, const int* idx,
                              long long n, float* out, int max_blocks,
                              cudaStream_t stream) {
  const long long total = n * (long long)c;
  if (total == 0) return 0;
  long long blocks = (total + 255) / 256;
  if (blocks > max_blocks) blocks = max_blocks;
  const size_t smem = (size_t)k * c * sizeof(float);
  lookup_kernel<<<(unsigned)blocks, 256, smem, stream>>>(tab, k, c, idx, total,
                                                         out);
  return (int)cudaGetLastError();
}
