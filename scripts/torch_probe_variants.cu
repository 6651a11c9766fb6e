// The P1, P3 and P4 probe steps side by side on Hopper (sm_90a), timed by
// scripts/torch_probe_variants.py: both forms of each step in
// voxtracer_torch/csrc/probes.cu (included here), forced at any row count,
// and forms weighed in their design that the port does not run.  They
// compute what probes.cu computes (the script holds each to the plain
// versions of voxtracer_torch/kernels/probes.py first) and differ only in
// how a step or the table is laid out.
//
// P1 (one 128-thread block a row):
//   0 copy, short chain   one copy of the row (bank conflicts), the index
//                         carried as a byte offset and the short chain
//   1 few ops             lane_gather_kernel<false> of probes.cu
//   2 short chain         lane_gather_kernel<true>
// P3 (chain_gather_kernel<copies, form> of probes.cu, up to 8 rows a block):
//   0 one copy            the 8 KB table once (bank conflicts), short chain,
//                         the port's launch shape
//   1 few ops             16 lane-class copies, acc += v first (3 ops a step)
//   2 short chain         16 lane-class copies: the port's P3
//   3 eight copies        8 lane-class copies (64 KB; ~2.95 words in the
//                         fullest bank), rows packed for two blocks an SM
// P4 (128-thread blocks):
//   0 four candidates     both y candidates, both compares and both halves
//                         formed from y, m and m2 selecting at the end
//   1 few ops             alu_loop_kernel<false> of probes.cu
//   2 short chain         alu_loop_kernel<true>
#include "../voxtracer_torch/csrc/probes.cu"

namespace {

__global__ void __launch_bounds__(LANES)
p1_one_copy_kernel(const int* __restrict__ tab, const int* __restrict__ idx, int iters,
                   int* __restrict__ out) {
  __shared__ int s[LANES];
  const int t = threadIdx.x;
  const long long e = (long long)blockIdx.x * LANES + t;
  s[t] = tab[e];
  uint32_t off = ((uint32_t)idx[e] & 127u) << 2, q = off, acc = 0;
  __syncthreads();
  const char* base = reinterpret_cast<const char*>(s);
#define STEP { const uint32_t v = *reinterpret_cast<const uint32_t*>(base + off); \
               off = ((v << 2) + q) & 0x1FCu; acc += v; q = off + (acc << 2); \
               asm("" : "+r"(q)); }
  for (int j = iters >> 2; j > 0; --j) { STEP STEP STEP STEP }
  for (int j = iters & 3; j > 0; --j) STEP
#undef STEP
  out[e] = (int)acc;
}

__device__ __forceinline__ void p4_four_step(uint32_t& x, float& y) {
  const uint32_t t = x & 16u;
  const bool m = t == 0u;
  const uint32_t xm = x + 1u + (t >> 4);
  const uint32_t xx = xm ^ (uint32_t)((int32_t)xm >> 3);
  const float c1 = __fadd_rn(__fmul_rn(y, 1.0000001f), 0.5f);
  const bool k1 = c1 < 1e9f, k0 = y < 1e9f;
  const float l = k1 ? c1 : __fmul_rn(c1, 0.5f);
  const float r = k0 ? y : __fmul_rn(y, 0.5f);
  y = m ? l : r;
  x = (m ? k1 : k0) ? xx : xm;
}

__global__ void __launch_bounds__(ALU_THREADS)
p4_four_kernel(const int* __restrict__ a, const float* __restrict__ b, long long n, int iters,
               int* __restrict__ out) {
  const long long e = (long long)blockIdx.x * ALU_THREADS + threadIdx.x;
  if (e >= n) return;
  uint32_t x = (uint32_t)a[e];
  float y = b[e];
  for (int j = iters >> 2; j > 0; --j) {
    p4_four_step(x, y); p4_four_step(x, y); p4_four_step(x, y); p4_four_step(x, y);
  }
  for (int j = iters & 3; j > 0; --j) p4_four_step(x, y);
  out[e] = (int)(x + (uint32_t)__float2int_rz(y));
}

}  // namespace

extern "C" {
// tab, idx, out: [rows, 128] i32.
int pv_lane_gather(int variant, const int* tab, const int* idx, int rows, int iters, int* out) {
  if (rows == 0) return 0;
  switch (variant) {
    case 0: p1_one_copy_kernel<<<rows, LANES>>>(tab, idx, iters, out); break;
    case 1: lane_gather_kernel<false><<<rows, LANES>>>(tab, idx, iters, out); break;
    case 2: lane_gather_kernel<true><<<rows, LANES>>>(tab, idx, iters, out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// tab: [2048] i32; idx, out: [rows, 128] i32.
int pv_chain_gather(int variant, const int* tab, const int* idx, int rows, int iters, int* out) {
  switch (variant) {
    case 0: return chain_gather_launch<1, true>(tab, idx, rows, iters, out, 0, 1);
    case 1: return chain_gather_launch<CHAIN_COPIES, false>(tab, idx, rows, iters, out, 0, 1);
    case 2: return chain_gather_launch<CHAIN_COPIES, true>(tab, idx, rows, iters, out, 0, 1);
    case 3: return chain_gather_launch<8, true>(tab, idx, rows, iters, out, 0, 2);
    default: return (int)cudaErrorInvalidValue;
  }
}

// a, out: [n] i32; b: [n] f32.
int pv_alu_loop(int variant, const int* a, const float* b, long long n, int iters, int* out) {
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + ALU_THREADS - 1) / ALU_THREADS);
  switch (variant) {
    case 0: p4_four_kernel<<<blocks, ALU_THREADS>>>(a, b, n, iters, out); break;
    case 1: alu_loop_kernel<false><<<blocks, ALU_THREADS>>>(a, b, n, iters, out); break;
    case 2: alu_loop_kernel<true><<<blocks, ALU_THREADS>>>(a, b, n, iters, out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
}  // extern "C"
