// Clipped row gather for small tables on Hopper (sm_90a), and its adjoint:
//   forward   out[i, c] = tab[clip(idx[i], 0, K - 1), c]
//   backward  d_tab[clip(idx[i], 0, K - 1), c] += ct[i, c]
//
// Replaces the TPU kernel voxtracer/kernels/lookup.py::lookup_rows (a
// where-chain over a VMEM-resident table) and, for the backward, the
// one-hot MXU products of voxtracer/diff/volumetric.py::_rows_bwd and
// _bsig_rows_bwd.  The plain PyTorch versions are
// voxtracer_torch/kernels/lookup.py::lookup_rows_plain and
// lookup_rows_bwd_plain; the grid sizes and the backward's accumulator are
// chosen there (fwd_blocks, bwd_plan).
//
// What bounds the forward on the card: bytes.  It reads a 4-byte index and
// writes C floats per row (58 MB for the material rows [256, 6] of a 1080p
// frame, 17 us at 3.35 TB/s); the table (6 KB) is read once per block.
// Design: one lane per 4 rows, so a lane reads its indices as one 16-byte
// load where the index array is 16-byte aligned (scalar loads otherwise,
// and for a ragged tail), with C a template parameter for the path's widths
// (1 brick sigma, 3 albedo, 5 the whitted queue's material rows, 6 the path
// and reproject material rows) and a generic loop for any other.  A warp gathers its slab of
// 128 rows x C floats into shared memory (C 16-byte stores per lane) and
// writes the slab out with 16-byte st.global.v4 stores, each warp store
// covering 512 contiguous bytes.  A slab starts at a row that is a multiple
// of 128, so its output is 16-byte aligned for every C.  The staging is
// done by the lanes themselves rather than by a bulk async copy: a slab is
// at most 3 KB and is written once, so a TMA store would add an mbarrier
// round trip per slab for no fewer bytes.  The table is read through L1
// (__ldg; a 6 KB table stays L1-resident, and neighbouring rays hit the
// same rows): staging it in each block's shared memory measured 5-11%
// slower at every path shape (PERF.md), and L1 puts no limit on K.
// The grid is persistent, sized from the device's SM count, and each warp
// loads its next slab's indices before it gathers the current one.
//
// What bounds the backward: collisions, then the work of sorting them out.
// At the albedo shape ~2.9M rows land on 10 of the 256 material rows, 46% on
// one; at the brick-sigma shape 98% of ~0.3M rows carry a zero cotangent
// and the ids sit on a few bricks.  Design: a lane takes 4 consecutive rows
// a step with 16-byte loads, drops rows whose cotangent is zero (they add
// nothing; NaN is kept), folds rows with the same clipped id into one
// (neighbouring rays hit the same material or brick) and packs what is left
// to the front.  For each slot still held by some lane, the lanes whose ids
// agree find each other with __match_any_sync and sum by a shuffle tree, so
// the group's lowest lane adds once.  The sum goes either into the warp's
// own K x C copy in shared memory (many rows per entry), with a plain add
// since the leaders of one step hold distinct ids, or straight into the
// L2-resident output with no-return global reductions (red.global.add.f32;
// few rows per entry).  A block then sums its 8 copies and adds each
// non-zero entry to the output once.  The entry point zeroes the output
// itself (cudaMemsetAsync on the stream).  Neither accumulator has a fixed
// summation order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                 // rows a lane takes a step
constexpr int kSlab = 32 * kRows;        // rows a warp takes a step
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int clip(int i, int k) { return min(max(i, 0), k - 1); }

// This lane's kRows indices of the slab at `r0` (zeros past the end).
__device__ __forceinline__ void load_ids(const int* __restrict__ idx, long long n,
                                         long long r0, bool vec, int lane, int (&ix)[kRows]) {
  const long long r = r0 + kRows * lane;
  if (vec && r0 + kSlab <= n) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(idx + r));
    ix[0] = v.x; ix[1] = v.y; ix[2] = v.z; ix[3] = v.w;
  } else {
#pragma unroll
    for (int q = 0; q < kRows; ++q) ix[q] = r + q < n ? __ldg(idx + r + q) : 0;
  }
}

// C > 0: the width at compile time; C == 0: the runtime width c.
template <int C>
__global__ void __launch_bounds__(kThreads, 4)
lookup_kernel(const float* __restrict__ tab, int k, int c_rt,
              const int* __restrict__ idx, long long n, float* __restrict__ out) {
  const int c = C > 0 ? C : c_rt;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* slab = smem + warp * kSlab * c;
  const bool vec = (reinterpret_cast<uintptr_t>(idx) & 15) == 0;
  const long long stride = (long long)gridDim.x * kWarps * kSlab;
  long long r0 = ((long long)blockIdx.x * kWarps + warp) * kSlab;
  int ix[kRows];
  if (r0 < n) load_ids(idx, n, r0, vec, lane, ix);
  for (; r0 < n; r0 += stride) {
    int cur[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) cur[q] = clip(ix[q], k) * c;
    if (r0 + stride < n) load_ids(idx, n, r0 + stride, vec, lane, ix);
    // gather this lane's rows into the slab
    if constexpr (C > 0) {
      float v[kRows * C];
#pragma unroll
      for (int q = 0; q < kRows; ++q)
#pragma unroll
        for (int j = 0; j < C; ++j) v[q * C + j] = __ldg(tab + cur[q] + j);
      float4* s4 = reinterpret_cast<float4*>(slab) + lane * C;
#pragma unroll
      for (int m = 0; m < C; ++m)
        s4[m] = make_float4(v[4 * m], v[4 * m + 1], v[4 * m + 2], v[4 * m + 3]);
    } else {
      for (int q = 0; q < kRows; ++q)
        for (int j = 0; j < c; ++j)
          slab[(kRows * lane + q) * c + j] = __ldg(tab + cur[q] + j);
    }
    __syncwarp();
    // write the slab out: 16-byte stores when it is whole
    float* o = out + r0 * c;
    if (r0 + kSlab <= n) {
      const float4* s4 = reinterpret_cast<const float4*>(slab);
      float4* o4 = reinterpret_cast<float4*>(o);
      if constexpr (C > 0) {
#pragma unroll
        for (int m = 0; m < C; ++m) o4[lane + 32 * m] = s4[lane + 32 * m];
      } else {
        for (int m = lane; m < 32 * c; m += 32) o4[m] = s4[m];
      }
    } else {
      const int nf = (int)(n - r0) * c;
      for (int j = lane; j < nf; j += 32) o[j] = slab[j];
    }
    __syncwarp();
  }
}

// Sum x over the lanes of `peers` (lanes with the same key) into the
// group's lowest lane, by a shuffle tree: each round a remaining lane adds
// the partial sum of the next remaining peer above it, and the peers at
// odd ranks drop out.  All 32 lanes must call it.
template <int W>
__device__ __forceinline__ void reduce_peers(unsigned peers, int lane, float (&x)[W]) {
  int rank = __popc(peers & ((1u << lane) - 1));
  unsigned above = peers & (0xfffffffeu << lane);
  while (__any_sync(kFull, above)) {
    const int next = __ffs(above);  // 1 + the next peer's lane, 0 if none
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const float y = __shfl_sync(kFull, x[j], (next - 1) & 31);
      if (next) x[j] += y;
    }
    above &= ~__ballot_sync(kFull, rank & 1);
    rank >>= 1;
  }
}

// This lane's kRows cotangent rows of the slab at `r0` (zeros past the end),
// as C 16-byte loads where `vec` says ct is 16-byte aligned.
template <int C>
__device__ __forceinline__ void load_rows(const float* __restrict__ ct, long long n,
                                          long long r0, bool vec, int lane,
                                          float (&x)[kRows][C]) {
  const long long r = r0 + kRows * lane;
  if (vec && r0 + kSlab <= n) {
    const float4* p = reinterpret_cast<const float4*>(ct + r * C);
#pragma unroll
    for (int m = 0; m < C; ++m) {
      const float4 v = __ldg(p + m);
      const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) x[(4 * m + e) / C][(4 * m + e) % C] = f[e];
    }
  } else {
#pragma unroll
    for (int q = 0; q < kRows; ++q)
#pragma unroll
      for (int j = 0; j < C; ++j) x[q][j] = r + q < n ? __ldg(ct + (r + q) * C + j) : 0.0f;
  }
}

// Add a group's sum to entry j: into the warp's own copy in shared memory
// (PRIV; the leaders of one step hold distinct ids, so no atomic is
// needed), else into the scratch of doubles with a no-return global
// reduction.
template <bool PRIV>
__device__ __forceinline__ void add(float* priv, double* scratch, int j, float v) {
  if constexpr (PRIV) priv[j] += v;
  else atomicAdd(scratch + j, (double)v);
}

// PRIV: each warp keeps its own K x C accumulator in shared memory; at the
// end a block sums its warps' copies and adds each non-zero sum to `out`
// with one global add.  Otherwise the group sums go into `scratch` (K x C
// doubles, then a counter of finished blocks, all zeroed by the entry
// point), and the last block to finish writes them to `out` as floats.
// For C > 0 a lane takes 4 consecutive rows a step (16-byte loads of ids
// and cotangents where aligned), drops rows whose cotangent is zero (they
// add nothing), folds each row into the first of its rows with the same
// id and moves the rows left to the front; then, slot by slot while any
// lane holds a row there, the warp's lanes with the same id sum.  C == 0
// takes one row a lane and loops over the columns.
template <int C, bool PRIV>
__global__ void __launch_bounds__(kThreads)
lookup_bwd_kernel(const float* __restrict__ ct, int c_rt, const int* __restrict__ idx,
                  long long n, int k, float* __restrict__ out, double* __restrict__ scratch) {
  const int c = C > 0 ? C : c_rt;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  extern __shared__ float s_acc[];
  float* acc = PRIV ? s_acc + warp * k * c : nullptr;
  if constexpr (PRIV) {
    for (int j = threadIdx.x; j < kWarps * k * c; j += kThreads) s_acc[j] = 0.0f;
    __syncthreads();
  }
  // warp-uniform trip counts: every lane reaches the warp intrinsics
  if constexpr (C > 0) {
    const bool vec_ids = (reinterpret_cast<uintptr_t>(idx) & 15) == 0;
    const bool vec_ct = (reinterpret_cast<uintptr_t>(ct) & 15) == 0;
    const long long stride = (long long)gridDim.x * kWarps * kSlab;
    for (long long r0 = ((long long)blockIdx.x * kWarps + warp) * kSlab; r0 < n;
         r0 += stride) {
      int key[kRows];
      float x[kRows][C];
      load_ids(idx, n, r0, vec_ids, lane, key);
      load_rows<C>(ct, n, r0, vec_ct, lane, x);
      // a slot past the end, of zeros (NaN is kept) or folded into an
      // earlier slot takes a key no other lane holds in that slot; every
      // index stays static, so x stays in registers
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        bool zero = true;
#pragma unroll
        for (int j = 0; j < C; ++j) zero = zero && x[q][j] == 0.0f;
        key[q] = r0 + kRows * lane + q < n && !zero ? clip(key[q], k) : -1 - lane;
      }
#pragma unroll
      for (int q = kRows - 1; q > 0; --q)
#pragma unroll
        for (int p = 0; p < q; ++p)
          if (key[q] >= 0 && key[q] == key[p]) {
#pragma unroll
            for (int j = 0; j < C; ++j) x[p][j] += x[q][j];
            key[q] = -1 - lane;
          }
      // the slots left move to the front, so the warp stops at the first
      // slot no lane holds
#pragma unroll
      for (int pass = 0; pass < kRows - 1; ++pass)
#pragma unroll
        for (int q = 0; q < kRows - 1; ++q) {
          const bool swap = key[q] < 0 && key[q + 1] >= 0;
          const int kq = key[q];
          key[q] = swap ? key[q + 1] : kq;
          key[q + 1] = swap ? kq : key[q + 1];
#pragma unroll
          for (int j = 0; j < C; ++j) {
            const float xq = x[q][j];
            x[q][j] = swap ? x[q + 1][j] : xq;
            x[q + 1][j] = swap ? xq : x[q + 1][j];
          }
        }
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        if (!__any_sync(kFull, key[q] >= 0)) break;
        const unsigned peers = __match_any_sync(kFull, key[q]);
        reduce_peers<C>(peers, lane, x[q]);
        if (key[q] >= 0 && (__ffs(peers) - 1) == lane) {
#pragma unroll
          for (int j = 0; j < C; ++j) add<PRIV>(acc, scratch, key[q] * C + j, x[q][j]);
        }
        __syncwarp();
      }
    }
  } else {
    const long long stride = (long long)gridDim.x * kThreads;
    for (long long base = (long long)blockIdx.x * kThreads + warp * 32; base < n;
         base += stride) {
      const long long r = base + lane;
      const bool live = r < n;
      const int key = live ? clip(__ldg(idx + r), k) : -1 - lane;
      const unsigned peers = __match_any_sync(kFull, key);
      for (int j = 0; j < c; ++j) {
        float x[1] = {live ? __ldg(ct + r * c + j) : 0.0f};
        reduce_peers<1>(peers, lane, x);
        if (live && (__ffs(peers) - 1) == lane) add<PRIV>(acc, scratch, key * c + j, x[0]);
        __syncwarp();
      }
    }
  }
  if constexpr (PRIV) {
    __syncthreads();
    for (int j = threadIdx.x; j < k * c; j += kThreads) {
      float v = 0.0f;
      for (int w = 0; w < kWarps; ++w) v += s_acc[w * k * c + j];
      if (v != 0.0f) atomicAdd(out + j, v);  // NaN != 0 is added too
    }
  } else {
    // the last block to get here finds every block's sums in the scratch
    __shared__ bool last;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned* done = reinterpret_cast<unsigned*>(scratch + (size_t)k * c);
      last = atomicAdd(done, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (last) {
      __threadfence();
      for (int j = threadIdx.x; j < k * c; j += kThreads) out[j] = (float)__ldcg(scratch + j);
    }
  }
}

template <int C>
cudaError_t launch_fwd(const float* tab, int k, int c, const int* idx, long long n, float* out,
                       int blocks, size_t smem, cudaStream_t s) {
  lookup_kernel<C><<<blocks, kThreads, smem, s>>>(tab, k, c, idx, n, out);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_bwd(bool priv, const float* ct, int c, const int* idx, long long n, int k,
                       float* out, double* scratch, int blocks, size_t smem, cudaStream_t s) {
  if (priv)
    lookup_bwd_kernel<C, true><<<blocks, kThreads, smem, s>>>(ct, c, idx, n, k, out, scratch);
  else
    lookup_bwd_kernel<C, false><<<blocks, kThreads, 0, s>>>(ct, c, idx, n, k, out, scratch);
  return cudaGetLastError();
}

template <typename K>
cudaError_t allow(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int C>
cudaError_t allow_all(int bytes) {
  cudaError_t e = cudaSuccess;
  for (cudaError_t f : {allow(lookup_kernel<C>, bytes), allow(lookup_bwd_kernel<C, true>, bytes)})
    if (f != cudaSuccess) e = f;
  return e;
}

}  // namespace

// Let every lookup kernel take up to `smem_optin` bytes of dynamic shared
// memory on the current device (the device's opt-in limit, 227 KB on an
// H100).  Called once per device, before the first launch.
extern "C" int vt_lookup_init(int smem_optin) {
  for (cudaError_t e : {allow_all<1>(smem_optin), allow_all<3>(smem_optin),
                        allow_all<5>(smem_optin), allow_all<6>(smem_optin),
                        allow_all<0>(smem_optin)})
    if (e != cudaSuccess) return (int)e;
  return 0;
}

// out [n, c] = tab [k, c] rows at clip(idx [n]) on a grid of `blocks`.
// out must be 16-byte aligned.
extern "C" int vt_lookup_rows(const float* tab, int k, int c, const int* idx, long long n,
                              float* out, int blocks, cudaStream_t stream) {
  if (n == 0) return 0;
  if ((reinterpret_cast<uintptr_t>(out) & 15) != 0) return (int)cudaErrorMisalignedAddress;
  const size_t smem = sizeof(float) * (size_t)c * kWarps * kSlab;
  switch (c) {
    case 1: return (int)launch_fwd<1>(tab, k, c, idx, n, out, blocks, smem, stream);
    case 3: return (int)launch_fwd<3>(tab, k, c, idx, n, out, blocks, smem, stream);
    case 5: return (int)launch_fwd<5>(tab, k, c, idx, n, out, blocks, smem, stream);
    case 6: return (int)launch_fwd<6>(tab, k, c, idx, n, out, blocks, smem, stream);
    default: return (int)launch_fwd<0>(tab, k, c, idx, n, out, blocks, smem, stream);
  }
}

// out [k, c] = the table cotangent of ct [n, c] at clip(idx [n]).  With
// `scratch` null the warp-private accumulators sum (8 copies of the table
// a block) into `out`, zeroed here first; else the group sums go into
// `scratch`, k * c + 1 doubles (8-byte aligned), zeroed here first, and
// the last block rounds them to `out`.
extern "C" int vt_lookup_rows_bwd(const float* ct, long long n, int c, const int* idx, int k,
                                  float* out, double* scratch, int blocks,
                                  cudaStream_t stream) {
  const bool priv = scratch == nullptr;
  cudaError_t e = priv || n == 0
      ? cudaMemsetAsync(out, 0, sizeof(float) * (size_t)k * c, stream)
      : cudaMemsetAsync(scratch, 0, sizeof(double) * ((size_t)k * c + 1), stream);
  if (e != cudaSuccess || n == 0) return (int)e;
  const size_t smem = priv ? sizeof(float) * kWarps * (size_t)k * c : 0;
  switch (c) {
    case 1: return (int)launch_bwd<1>(priv, ct, c, idx, n, k, out, scratch, blocks, smem, stream);
    case 3: return (int)launch_bwd<3>(priv, ct, c, idx, n, k, out, scratch, blocks, smem, stream);
    case 5: return (int)launch_bwd<5>(priv, ct, c, idx, n, k, out, scratch, blocks, smem, stream);
    case 6: return (int)launch_bwd<6>(priv, ct, c, idx, n, k, out, scratch, blocks, smem, stream);
    default:
      return (int)launch_bwd<0>(priv, ct, c, idx, n, k, out, scratch, blocks, smem, stream);
  }
}
