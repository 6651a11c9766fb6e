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
// What bounds them on this card.  Each element is a chain of `iters`
// dependent steps, and the chains are the only parallelism: one thread an
// element, B x 128 threads.  At B = 256 that is 8 warps an SM, 2 a warp
// scheduler, too few to cover a step's latency, so the loops are bound by the
// latency of one step of the chain and not by the SM's load or ALU rates.
// At B = 1024 (8 warps a scheduler) the SM's issue rates bind instead: the
// int32 lanes (64 a clock), and for a P1 that reads one copy of its row the
// shared-memory wavefronts: random indices into a 128-word row spread over
// 32 banks put ~2.8 words in a warp's fullest bank.  The designs below
// keep, for every element, `iters` dependent table reads (P1, P3) or loop
// bodies (P4): a shorter chain, never a shortcut of it.  `iters` stays a
// runtime argument, so the compiler can neither fold nor drop the loop, and
// P1 and P4 are unrolled by 4 with a remainder loop.
//
// P1: each block stages its 128-entry row 32 times, lane-skewed (entry e for
// lane l at word e * 32 + l, 16 KB a block), so every lane reads only its own
// bank and each load is one wavefront whatever the indices.  The index is
// carried as a byte offset into that copy, index * 128 + lane * 4: the lane
// bits sit below the index bits and survive the add, so a step is a
// shift-add and one mask.
//
// P4: the loop body is inline PTX, so that ptxas keeps its predicated shape
// (from C++ it rebuilds selects and lengthens the chain).  m = !(x & 16) is
// one LOP3 with a predicate result; x + 1 + bit 4 is x + 1 with + 2 under the
// predicate; the xor is predicated on m2 (no SEL); y is an FMUL, an FADD
// under m and an FMUL by 0.5 under !m2.
//
// Each of the two has two forms of the step, one for each bound, and the
// launch picks by the warps a scheduler carries: one 128-thread block a row
// of 128, so the busiest SM carries ceil(4B / SMs) warps, the least the count
// allows, and B / SMs a scheduler.
//   - Short chain, while the schedulers carry few warps and a step's latency
//     binds.  P1: q = offset + acc * 128 is formed while the load is in
//     flight, so the chain is load -> IMAD (q + v * 128) -> LOP3 (mask) ->
//     load, 4 integer ops a step.  P4: m2 = (y1 < 1e9) is read from y before
//     the step, y < 999999872 under m (y * 1.0000001f + 0.5f is monotone in
//     y, and 999999872 is the least float it takes to 1e9) and y < 1e9
//     otherwise: one FSEL of the threshold and one FSETP, off the y chain.
//     Ten instructions a step; the loop-carried chains are 4 long (LOP3 ->
//     IADD -> SHF -> LOP3, and LOP3 -> FSEL -> FSETP -> LOP3), y's 3
//     (FMUL -> FADD -> FMUL).
//   - Few ops, past that, where the SM's issue rates bind.  P1: acc += v,
//     offset = (offset + acc * 128) & mask, 3 integer ops a step (and 3 on
//     the chain).  P4: m2 = y1 < 1e9 after the step's add, nine instructions
//     a step (no FSEL), but y's chain is 4 (FMUL -> FADD -> FSETP -> FMUL):
//     the compare waits for the add.
// The switch points, P1_SHORT_CHAIN_WARPS and P4_SHORT_CHAIN_WARPS, are where
// the two forms cross on the H100 (scripts/torch_probe_variants.py sweeps B
// over 2-8 warps a scheduler): P1's short chain is faster up to 5 warps a
// scheduler and slower from 6, P4's up to 2 and slower from 3.
//
// P3 (the direct kernel): the whole 8 KB table staged in each block's shared
// memory and read directly, where the TPU had to reach entries past 128
// through a 16-block where-chain.  Its random indices meet bank conflicts
// (~3.5 words in a warp's fullest bank); a lane-skewed copy would take 256 KB.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;          // one row of the lane table
constexpr int CHAIN_ENTRIES = 2048; // 16 blocks of 128

constexpr int SKEW = 32;                 // copies of a row, one a lane
constexpr uint32_t OFFSET_MASK = 0x3FFFu; // byte offsets into LANES * SKEW words
// Warps a scheduler up to which P1 and P4 take their short chain.
constexpr int P1_SHORT_CHAIN_WARPS = 5;
constexpr int P4_SHORT_CHAIN_WARPS = 2;

// One step of P1 from the byte offset `off` (index * 128 + lane * 4) of the
// lane-skewed row `s`.  SHORT_CHAIN: q holds off + acc * 128 before the step.
template <bool SHORT_CHAIN>
__device__ __forceinline__ void lane_step(const char* s, uint32_t& off, uint32_t& q,
                                          uint32_t& acc) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(s + off);
  if (SHORT_CHAIN) {
    off = ((v << 7) + q) & OFFSET_MASK;
    acc += v;
    q = off + (acc << 7);
    asm("" : "+r"(q));  // keep q formed here, off the load -> load chain
  } else {
    acc += v;
    off = (off + (acc << 7)) & OFFSET_MASK;
  }
}

template <bool SHORT_CHAIN>
__global__ void __launch_bounds__(LANES)
lane_gather_kernel(const int* __restrict__ tab, const int* __restrict__ idx,
                   int iters, int* __restrict__ out) {
  __shared__ int s_tab[LANES * SKEW];
  const int t = threadIdx.x;
  const int* row = tab + (long long)blockIdx.x * LANES;
  for (int w = t; w < LANES * SKEW; w += LANES) s_tab[w] = row[w / SKEW];
  const long long e = (long long)blockIdx.x * LANES + t;
  // step 1's index is idx & 127 (acc is 0)
  uint32_t off = (((uint32_t)idx[e] & (LANES - 1)) << 7) | ((uint32_t)(t % SKEW) << 2);
  uint32_t q = off, acc = 0;
  __syncthreads();
  const char* s = reinterpret_cast<const char*>(s_tab);
  for (int j = iters >> 2; j > 0; --j) {
    lane_step<SHORT_CHAIN>(s, off, q, acc);
    lane_step<SHORT_CHAIN>(s, off, q, acc);
    lane_step<SHORT_CHAIN>(s, off, q, acc);
    lane_step<SHORT_CHAIN>(s, off, q, acc);
  }
  for (int j = iters & 3; j > 0; --j) lane_step<SHORT_CHAIN>(s, off, q, acc);
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

constexpr int ALU_THREADS = 128;

// One step of P4; 0f4E6E6B28 is 1e9f, 0f4E6E6B26 999999872.0f, 0f3F800001
// 1.0000001f (1 + 2^-23), 0f3F000000 0.5f.
template <bool SHORT_CHAIN>
__device__ __forceinline__ void alu_step(uint32_t& x, float& y) {
  if (SHORT_CHAIN) {
    asm("{\n\t"
        ".reg .pred nm, m2;\n\t"
        ".reg .b32 t, xm, sh;\n\t"
        ".reg .f32 c, thr;\n\t"
        "and.b32 t, %0, 16;\n\t"
        "setp.ne.u32 nm, t, 0;\n\t"                       // !m
        "selp.f32 thr, 0f4E6E6B28, 0f4E6E6B26, nm;\n\t"
        "setp.lt.f32 m2, %1, thr;\n\t"                    // y1 < 1e9, from y
        "add.u32 xm, %0, 1;\n\t"
        "@nm add.u32 xm, %0, 2;\n\t"                      // x + 1 + bit 4
        "mul.rn.f32 c, %1, 0f3F800001;\n\t"
        "@!nm add.rn.f32 %1, c, 0f3F000000;\n\t"          // y1
        "shr.s32 sh, xm, 3;\n\t"
        "@m2 xor.b32 xm, xm, sh;\n\t"
        "@!m2 mul.rn.f32 %1, %1, 0f3F000000;\n\t"
        "mov.b32 %0, xm;\n\t"
        "}" : "+r"(x), "+f"(y));
  } else {
    asm("{\n\t"
        ".reg .pred nm, m2;\n\t"
        ".reg .b32 t, xm, sh;\n\t"
        ".reg .f32 c;\n\t"
        "and.b32 t, %0, 16;\n\t"
        "setp.ne.u32 nm, t, 0;\n\t"                       // !m
        "add.u32 xm, %0, 1;\n\t"
        "@nm add.u32 xm, %0, 2;\n\t"                      // x + 1 + bit 4
        "mul.rn.f32 c, %1, 0f3F800001;\n\t"
        "@!nm add.rn.f32 %1, c, 0f3F000000;\n\t"          // y1
        "setp.lt.f32 m2, %1, 0f4E6E6B28;\n\t"             // y1 < 1e9
        "shr.s32 sh, xm, 3;\n\t"
        "@m2 xor.b32 xm, xm, sh;\n\t"
        "@!m2 mul.rn.f32 %1, %1, 0f3F000000;\n\t"
        "mov.b32 %0, xm;\n\t"
        "}" : "+r"(x), "+f"(y));
  }
}

template <bool SHORT_CHAIN>
__global__ void __launch_bounds__(ALU_THREADS)
alu_loop_kernel(const int* __restrict__ a, const float* __restrict__ b,
                long long n, int iters, int* __restrict__ out) {
  const long long e = (long long)blockIdx.x * ALU_THREADS + threadIdx.x;
  if (e >= n) return;
  uint32_t x = (uint32_t)a[e];
  float y = b[e];
  for (int j = iters >> 2; j > 0; --j) {
    alu_step<SHORT_CHAIN>(x, y);
    alu_step<SHORT_CHAIN>(x, y);
    alu_step<SHORT_CHAIN>(x, y);
    alu_step<SHORT_CHAIN>(x, y);
  }
  for (int j = iters & 3; j > 0; --j) alu_step<SHORT_CHAIN>(x, y);
  out[e] = (int)(x + (uint32_t)__float2int_rz(y));
}

// 1 when `blocks` blocks of 4 warps carry at most `warps` warps a scheduler
// on the current device, 0 when more, minus the cudaError_t on an error.
int short_chain(long long blocks, int warps) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  return blocks <= (long long)warps * sms ? 1 : 0;
}

}  // namespace

extern "C" {

// The form of the step a launch of `blocks` 128-thread blocks takes on the
// current device: 1 the short chain, 0 few ops, minus the cudaError_t on an
// error.  probe: 1 lane gather (P1), 4 ALU loop (P4).
int vt_probe_short_chain(int probe, long long blocks) {
  if (probe == 1) return short_chain(blocks, P1_SHORT_CHAIN_WARPS);
  if (probe == 4) return short_chain(blocks, P4_SHORT_CHAIN_WARPS);
  return -(int)cudaErrorInvalidValue;
}

// tab, idx, out: [rows, 128] i32.
int vt_lane_gather(const int* tab, const int* idx, int rows, int iters,
                   int* out, cudaStream_t stream) {
  if (rows == 0) return 0;
  const int form = vt_probe_short_chain(1, rows);
  if (form < 0) return -form;
  if (form)
    lane_gather_kernel<true><<<rows, LANES, 0, stream>>>(tab, idx, iters, out);
  else
    lane_gather_kernel<false><<<rows, LANES, 0, stream>>>(tab, idx, iters, out);
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
  const long long blocks = (n + ALU_THREADS - 1) / ALU_THREADS;
  const int form = vt_probe_short_chain(4, blocks);
  if (form < 0) return -form;
  if (form)
    alu_loop_kernel<true><<<(unsigned)blocks, ALU_THREADS, 0, stream>>>(a, b, n, iters, out);
  else
    alu_loop_kernel<false><<<(unsigned)blocks, ALU_THREADS, 0, stream>>>(a, b, n, iters, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
