// Gather and ALU probes for Hopper (sm_90a): the counterparts of the three
// Pallas kernels of scripts/probe_pallas.py, run by voxtracer_torch.probe.
//
//   P1 lane gather (p1_lane_gather.run):  tab, idx i32 [B, 128]; iters times
//        idx = (idx + acc) & 127;   acc += tab[b, idx]          -> acc
//   P3 2048-entry gather (p3_chain_gather.run):  tab i32 [16, 128] read as
//        2048 entries, idx i32 [B, 128]; iters times
//        idx = (idx + acc) & 2047;  acc += tab_flat[idx]        -> acc
//   P4 DDA-shaped op mix (p4_vpu_ops.run):  x = a i32, y = b f32 [B, 128];
//        iters times
//        m = (x & 31) < 16;  y = m ? y * 1.0000001f + 0.5f : y;  x += m ? 1 : 2;
//        m2 = y < 1e9f;  x = m2 ? x ^ (x >> 3) : x;  y = m2 ? y : y * 0.5f
//        -> x + (int)y
// The plain PyTorch versions are voxtracer_torch/kernels/probes.py
// (lane_gather_plain, chain_gather_plain, alu_loop_plain).  Each kernel
// computes what the Pallas body computes for any input: integer arithmetic
// runs in uint32_t so it wraps as int32 does in JAX and torch, `x >> 3`
// stays an arithmetic shift of the signed value, the float is converted
// toward zero with saturation, and the build's --fmad=false keeps P4's
// multiply and add apart, as torch runs them.
//
// What bounds them on the card: not bytes (each reads and writes its
// [B, 128] arrays once) but the loop.  P1 and P3 run one shared-memory
// load and three integer operations per element and iteration, so their
// ceiling is the SM's shared-memory port (32 four-byte loads per clock) and
// its int32 lanes; each load depends on the one before it, so with B x 128
// threads the latency of that chain is what the probes really measure.
// P4 is 13 register operations per iteration, bound by the SM's dispatch rate
// and int32 lanes.
//
// Design: one thread per element, the loop count a runtime argument (so the
// compiler can neither unroll the loop away nor fold it) and the result
// stored.  P1 gives each row of 128 elements its own block, which stages
// that row of the table in shared memory (512 B); P3 stages the whole
// 8 KB table in each block's shared memory and reads it directly, where the
// TPU had to reach entries past 128 through a 16-block where-chain.  The
// gathers' indices are random within the table, so a warp's loads meet
// bank conflicts: they are part of what is measured.  P4 keeps everything
// in registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;          // one row of the lane table
constexpr int CHAIN_ENTRIES = 2048; // 16 blocks of 128

__global__ void __launch_bounds__(LANES)
lane_gather_kernel(const int* __restrict__ tab, const int* __restrict__ idx,
                   int iters, int* __restrict__ out) {
  __shared__ int s_tab[LANES];
  const long long e = (long long)blockIdx.x * LANES + threadIdx.x;
  s_tab[threadIdx.x] = tab[e];
  uint32_t ix = (uint32_t)idx[e];
  __syncthreads();
  uint32_t acc = 0;
  for (int i = 0; i < iters; ++i) {
    ix = (ix + acc) & (LANES - 1);
    acc += (uint32_t)s_tab[ix];
  }
  out[e] = (int)acc;
}

__global__ void __launch_bounds__(LANES)
chain_gather_kernel(const int* __restrict__ tab, const int* __restrict__ idx,
                    int iters, int* __restrict__ out) {
  __shared__ int s_tab[CHAIN_ENTRIES];
  for (int j = threadIdx.x; j < CHAIN_ENTRIES; j += LANES) s_tab[j] = tab[j];
  const long long e = (long long)blockIdx.x * LANES + threadIdx.x;
  uint32_t ix = (uint32_t)idx[e];
  __syncthreads();
  uint32_t acc = 0;
  for (int i = 0; i < iters; ++i) {
    ix = (ix + acc) & (CHAIN_ENTRIES - 1);
    acc += (uint32_t)s_tab[ix];
  }
  out[e] = (int)acc;
}

__global__ void __launch_bounds__(256)
alu_loop_kernel(const int* __restrict__ a, const float* __restrict__ b,
                long long n, int iters, int* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  uint32_t x = (uint32_t)a[e];
  float y = b[e];
  for (int i = 0; i < iters; ++i) {
    const bool m = (x & 31u) < 16u;
    y = m ? y * 1.0000001f + 0.5f : y;
    x += m ? 1u : 2u;
    const bool m2 = y < 1e9f;
    x = m2 ? x ^ (uint32_t)((int32_t)x >> 3) : x;
    y = m2 ? y : y * 0.5f;
  }
  out[e] = (int)(x + (uint32_t)__float2int_rz(y));
}

}  // namespace

extern "C" {

// tab, idx, out: [rows, 128] i32.
int vt_lane_gather(const int* tab, const int* idx, int rows, int iters,
                   int* out, cudaStream_t stream) {
  if (rows == 0) return 0;
  lane_gather_kernel<<<rows, LANES, 0, stream>>>(tab, idx, iters, out);
  return (int)cudaGetLastError();
}

// tab: [2048] i32; idx, out: [rows, 128] i32.
int vt_chain_gather(const int* tab, const int* idx, int rows, int iters,
                    int* out, cudaStream_t stream) {
  if (rows == 0) return 0;
  chain_gather_kernel<<<rows, LANES, 0, stream>>>(tab, idx, iters, out);
  return (int)cudaGetLastError();
}

// a, out: [n] i32; b: [n] f32.
int vt_alu_loop(const int* a, const float* b, long long n, int iters, int* out,
                cudaStream_t stream) {
  if (n == 0) return 0;
  const long long blocks = (n + 255) / 256;
  alu_loop_kernel<<<(unsigned)blocks, 256, 0, stream>>>(a, b, n, iters, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
