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
// 32 banks put ~2.8 words in a warp's fullest bank; P3's two wavefronts a
// load (below) bind with its int32 ops there.  The designs below
// keep, for every element, `iters` dependent table reads (P1, P3) or loop
// bodies (P4): a shorter chain, never a shortcut of it.  `iters` stays a
// runtime argument, so the compiler can neither fold nor drop the loop, and
// each loop is unrolled by 4 with a remainder loop.
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
// P3 can take no lane-skewed copy: 32 copies of its 2,048 words are 256 KB,
// past the 227 KB a block may use.  It stages 16, one a lane class (lane %
// 16): entry e for class c at word e * 16 + c, 128 KB of dynamic shared
// memory.  Lanes l and l + 16 share a class, and a class owns two banks (c
// and c + 16, by the entry's parity), so no bank holds more than two
// distinct words of a warp's load: two wavefronts at most, whatever the
// indices (a single copy puts ~3.5 words in the fullest bank on random
// indices, up to 32 on adversarial ones).  The index is carried as the byte
// offset e * 64 + c * 4 and the step is P1's, shift and mask widened (the
// short chain: load -> IMAD -> LOP3 -> load).  At 128 KB an SM holds one
// block, so a block packs up to 8 rows of 128 (1,024 threads), ceil(B /
// SMs) of them: B = 256 runs as 128 blocks of 256 threads (2 warps a
// scheduler, as one row a block would give), B = 1024 as 128 blocks of
// 1,024.  A block whose last rows lie past B stages with all its threads
// and reads and writes only its own rows.  P3 has one form of the step, the
// short chain: from 6 warps a scheduler the wavefronts bind (two a warp's
// load), and there the 3-op few-ops form ties with it (63.5-64.4 cycles an
// iteration at B = 1024 on the H100, scripts/torch_probe_variants.py);
// below, it is ~6 cycles slower.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

namespace {

constexpr int LANES = 128;          // one row of the lane table
constexpr int CHAIN_ENTRIES = 2048; // 16 blocks of 128

constexpr int SKEW = 32;                 // copies of a row, one a lane
constexpr int CHAIN_COPIES = 16;         // copies of the chain table, one a lane class
constexpr int CHAIN_MAX_ROWS = 8;        // rows of 128 a P3 block: 1,024 threads
// Warps a scheduler up to which P1 and P4 take their short chain.
constexpr int P1_SHORT_CHAIN_WARPS = 5;
constexpr int P4_SHORT_CHAIN_WARPS = 2;

__host__ __device__ constexpr int log2i(int n) { return n > 1 ? 1 + log2i(n / 2) : 0; }

// One step of a gather from `s`, which holds COPIES copies of an
// ENTRIES-entry table (entry e, copy c at word e * COPIES + c), from the
// byte offset `off` (e * COPIES * 4 + c * 4): the copy bits sit below the
// entry bits and survive the add.  SHORT_CHAIN: q holds off + (acc << SHIFT)
// before the step.  P1 is <128, 32>, P3 <2048, 16>.
template <int ENTRIES, int COPIES, bool SHORT_CHAIN>
__device__ __forceinline__ void gather_step(const char* s, uint32_t& off, uint32_t& q,
                                            uint32_t& acc) {
  constexpr int SHIFT = log2i(COPIES) + 2;
  constexpr uint32_t MASK = (uint32_t)ENTRIES * COPIES * 4 - 1;
  const uint32_t v = *reinterpret_cast<const uint32_t*>(s + off);
  if (SHORT_CHAIN) {
    off = ((v << SHIFT) + q) & MASK;
    acc += v;
    q = off + (acc << SHIFT);
    asm("" : "+r"(q));  // keep q formed here, off the load -> load chain
  } else {
    acc += v;
    off = (off + (acc << SHIFT)) & MASK;
  }
}

// `iters` steps from `off`, unrolled by 4 -> acc.
template <int ENTRIES, int COPIES, bool SHORT_CHAIN>
__device__ __forceinline__ uint32_t gather_loop(const char* s, uint32_t off, int iters) {
  uint32_t q = off, acc = 0;
  for (int j = iters >> 2; j > 0; --j) {
    gather_step<ENTRIES, COPIES, SHORT_CHAIN>(s, off, q, acc);
    gather_step<ENTRIES, COPIES, SHORT_CHAIN>(s, off, q, acc);
    gather_step<ENTRIES, COPIES, SHORT_CHAIN>(s, off, q, acc);
    gather_step<ENTRIES, COPIES, SHORT_CHAIN>(s, off, q, acc);
  }
  for (int j = iters & 3; j > 0; --j) gather_step<ENTRIES, COPIES, SHORT_CHAIN>(s, off, q, acc);
  return acc;
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
  const uint32_t off = (((uint32_t)idx[e] & (LANES - 1)) << 7) | ((uint32_t)(t % SKEW) << 2);
  __syncthreads();
  out[e] = (int)gather_loop<LANES, SKEW, SHORT_CHAIN>(reinterpret_cast<const char*>(s_tab),
                                                      off, iters);
}

// The bytes of shared memory P3 stages with COPIES copies of its table.
template <int COPIES>
constexpr int chain_smem() { return CHAIN_ENTRIES * COPIES * 4; }

// P3 over `rows` rows of 128, blockDim.x / 128 rows a block (the last block
// may hold fewer), with COPIES copies of the table (COPIES 16 is the
// port's; scripts/torch_probe_variants.cu weighs 1 and 8).  Each thread
// reads its index first, so that load overlaps the staging.  The staging
// stores 16-byte chunks, 32 consecutive ones a warp at a time, so the
// STS.128 are conflict-free; with COPIES >= 4 a warp loads 32 consecutive
// entries (one a lane, each entry once a block) and hands each chunk its
// entry by a shuffle.  A thread issues all its loads of `tab` (at most 16)
// before its first store, so the staging waits for one round trip to L2:
// one load at a time, it took longer than 512 steps of the chain.
template <int COPIES, bool SHORT_CHAIN>
__global__ void __launch_bounds__(LANES * CHAIN_MAX_ROWS)
chain_gather_kernel(const int* __restrict__ tab, const int* __restrict__ idx, int rows,
                    int iters, int* __restrict__ out) {
  extern __shared__ uint4 s_chain[];
  constexpr int SHIFT = log2i(COPIES) + 2;
  const int t = threadIdx.x;
  const int row = blockIdx.x * (blockDim.x / LANES) + t / LANES;
  const long long e = (long long)row * LANES + t % LANES;
  // step 1's index is idx & 2047 (acc is 0)
  const uint32_t off = row < rows
      ? (((uint32_t)idx[e] & (CHAIN_ENTRIES - 1)) << SHIFT) | ((uint32_t)(t % COPIES) << 2)
      : 0u;
  if constexpr (COPIES >= 4) {
    constexpr int PER = COPIES / 4;                  // chunks an entry
    constexpr int LOADS = CHAIN_ENTRIES / LANES;     // a thread's entries at one row a block
    const int lane = t % 32;
    int v[LOADS];
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
      const int base = t - lane + k * blockDim.x;
      if (base < CHAIN_ENTRIES) v[k] = tab[base + lane];
    }
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
      const int base = t - lane + k * blockDim.x;    // the warp's 32 entries
      if (base >= CHAIN_ENTRIES) break;
#pragma unroll
      for (int r = 0; r < PER; ++r) {                // chunk 32 r + lane of them
        const int w = __shfl_sync(0xffffffffu, v[k], (32 * r + lane) / PER);
        s_chain[base * PER + 32 * r + lane] = make_uint4(w, w, w, w);
      }
    }
  } else {
#pragma unroll 4
    for (int j = t; j < CHAIN_ENTRIES * COPIES / 4; j += blockDim.x)
      s_chain[j] = make_uint4(tab[(j * 4) / COPIES], tab[(j * 4 + 1) / COPIES],
                              tab[(j * 4 + 2) / COPIES], tab[(j * 4 + 3) / COPIES]);
  }
  __syncthreads();
  if (row >= rows) return;
  out[e] = (int)gather_loop<CHAIN_ENTRIES, COPIES, SHORT_CHAIN>(
      reinterpret_cast<const char*>(s_chain), off, iters);
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

// P3 with COPIES copies of the table over `rows` rows of 128, on the current
// device: ceil(rows / (SMs x blocks_an_sm)) rows a block, 1 to 8, so the
// blocks fill the SMs at blocks_an_sm each before a block packs more rows.
// The dynamic shared memory past 48 KB is allowed once a device.  Returns
// the cudaError_t of the attribute call or the launch.
template <int COPIES, bool SHORT_CHAIN>
int chain_gather_launch(const int* tab, const int* idx, int rows, int iters, int* out,
                        cudaStream_t stream, int blocks_an_sm) {
  if (rows == 0) return 0;
  static std::atomic<unsigned long long> allowed{0};  // a bit a device
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (err == cudaSuccess && !(allowed.load() & bit)) {
    err = cudaFuncSetAttribute(chain_gather_kernel<COPIES, SHORT_CHAIN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, chain_smem<COPIES>());
    if (err == cudaSuccess) allowed |= bit;
  }
  if (err != cudaSuccess) return (int)err;
  const long long fill = (long long)sms * blocks_an_sm;
  const int per_block =
      (int)std::min<long long>(std::max<long long>((rows + fill - 1) / fill, 1), CHAIN_MAX_ROWS);
  chain_gather_kernel<COPIES, SHORT_CHAIN>
      <<<(rows + per_block - 1) / per_block, per_block * LANES, chain_smem<COPIES>(), stream>>>(
          tab, idx, rows, iters, out);
  return (int)cudaGetLastError();
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
  return chain_gather_launch<CHAIN_COPIES, true>(tab, idx, rows, iters, out, stream, 1);
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
