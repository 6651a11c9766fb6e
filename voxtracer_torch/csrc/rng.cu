// Counter-based random streams on Hopper (sm_90a): one launch a draw.
//
// Replaces no Pallas kernel.  The JAX package draws its streams
// (voxtracer/core/rng.py: the PCG hash, and jax.random's threefry2x32)
// with XLA elementwise ops, and the port first did the same with torch
// ops on int64 tensors (torch has no uint32 add or right shift): 41
// launches a hash draw, about 200 a threefry normal, each reading and
// writing a tensor of int64 words.  The plain versions are
// voxtracer_torch/core/rng.py::hash_uniform_plain, hash_normal_plain,
// threefry_uniform_plain and threefry_normal_plain; the counter map and
// the words of the key are computed on the host by
// voxtracer_torch/kernels/rng.py.
//
// Each element of a draw gets a counter: its row-major index in the
// global array when the draw holds a window of lanes (a rank's share of a
// sharded frame) or a list of them (the queue slots of a sharded whitted
// batch), its own index otherwise.  The generator then runs on that
// counter in 32-bit registers:
//   hash      pcg(pcg(lo ^ base) ^ mix), the PCG-RXS-M-XS permutation;
//   threefry  y0 ^ y1 of threefry-2x32 (20 rounds) on (hi, lo) under (k0, k1);
// and the output turns the word into a float32:
//   uniform   hash: (bits >> 8) * 2^-24; threefry: the top 23 bits as the
//             mantissa of a float in [1, 2), minus one;
//   normal    hash: Box-Muller over two streams (salt and salt + 0x5D0);
//             threefry: sqrt(2) * erf_inv(u) over u in (-1, 1), by XLA's
//             polynomial (M. Giles, 2011).
// Every float operation is the one the plain version's torch ops perform,
// in the same order and each rounded to float32: logf, log1pf and cosf
// as torch's CUDA kernels call them, IEEE square roots, no fast math, and
// no multiply-add contraction (the build's --fmad=false).  So each stream
// equals its plain version bit for bit.
//
// What bounds it on this card.  Threefry and the normals are bound by
// operations: 20 rounds of an add, a funnel shift and a xor, with key
// injections, are about 75 integer operations a word; a normal adds a
// logf, a square root and a cosf (Box-Muller, two hashes) or a log1pf, a
// square root and a degree-8 polynomial (erf_inv).  A hash uniform is bound
// by its store: two PCG steps and a conversion, about 21 operations,
// against 4 bytes written.  Nothing is read but the queue form's lane list.
// Design: no int64 tensor, counter tensor or intermediate reaches device
// memory; only the float32 result is written.  A thread makes kPer
// consecutive elements, so the generator's chains run side by side
// (independent instructions for the scheduler to interleave), and stores
// them as one 16-byte store (the output is 16-byte aligned, so every full
// group is); a ragged tail stores element by element.  Rotations are
// single funnel shifts (SHF).  The counter takes a 32-bit division by the
// row length where the draw's rows are apart in the global array (one
// more with a lane list), and none where they are not.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;  // consecutive elements a thread

enum Gen { kHash = 0, kThreefry = 1 };
enum Out { kUniform = 0, kNormal = 1 };

// Element i of a draw of n sits in row r = i / blk at q = i - r * blk of the
// row; its counter is r * row_stride + off + q, or with a lane list
// r * row_stride + lanes[q / inner] * inner + q % inner.
struct CounterMap {
  unsigned n;                     // elements of the draw
  unsigned blk;                   // elements of a row: shape[axis] * inner
  unsigned inner;                 // elements after the lane axis
  unsigned long long row_stride;  // counters of a row in the global array: total * inner
  unsigned long long off;         // first * inner
  const long long* lanes;         // shape[axis] global lane indices, or null
};

// The generator's words: hash (base, mix) of the first stream and of the
// second (the normal's); threefry (k0, k1).
struct Words {
  uint32_t w0, w1, w2, w3;
};

__device__ __forceinline__ unsigned long long counter(const CounterMap& m, unsigned i) {
  if (m.lanes == nullptr && m.row_stride == m.blk) return m.off + i;
  const unsigned r = i / m.blk;
  const unsigned q = i - r * m.blk;
  const unsigned long long row = (unsigned long long)r * m.row_stride;
  if (m.lanes == nullptr) return row + m.off + q;
  const unsigned a = q / m.inner;
  return row + (unsigned long long)__ldg(m.lanes + a) * m.inner + (q - a * m.inner);
}

// PCG-RXS-M-XS output permutation (O'Neill 2014).
__device__ __forceinline__ uint32_t pcg(uint32_t x) {
  x = x * 747796405u + 2891336453u;
  x = ((x >> ((x >> 28) + 4u)) ^ x) * 277803737u;
  return (x >> 22) ^ x;
}

__device__ __forceinline__ uint32_t hash_bits(uint32_t lo, uint32_t base, uint32_t mix) {
  return pcg(pcg(lo ^ base) ^ mix);
}

// Threefry-2x32, 20 rounds (Salmon et al. 2011, as jax.random runs it).
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1, uint32_t hi,
                                                  uint32_t lo) {
  constexpr int kRot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  uint32_t x0 = hi + ks[0], x1 = lo + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, kRot[(i & 1) * 4 + j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return x0 ^ x1;
}

__device__ __forceinline__ float hash_unit(uint32_t bits) {
  return __uint2float_rn(bits >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

__device__ __forceinline__ float threefry_unit(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// erf_inv as XLA expands it in float32 (voxtracer_torch/core/rng.py erf_inv):
// the w < 5 and w >= 5 polynomials, each coefficient rounded from double.
__device__ __forceinline__ float erf_inv(float x) {
  constexpr double kLo[9] = {2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                             0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                             1.50140941};
  constexpr double kHi[9] = {-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                             0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                             2.83297682};
  float w = -log1pf(x * -x);
  const bool lt = w < 5.0f;
  w = lt ? w - 2.5f : __fsqrt_rn(w) - 3.0f;
  float p = lt ? (float)kLo[0] : (float)kHi[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = (lt ? (float)kLo[i] : (float)kHi[i]) + p * w;
  return fabsf(x) == 1.0f ? x * __int_as_float(0x7F800000) : p * x;
}

template <Gen G, Out O>
__device__ __forceinline__ float draw(const CounterMap& m, const Words& k, unsigned i) {
  const unsigned long long c = counter(m, i);
  const uint32_t lo = (uint32_t)c;
  if constexpr (G == kHash) {
    const float u1 = hash_unit(hash_bits(lo, k.w0, k.w1));
    if constexpr (O == kUniform) {
      return u1;
    } else {
      const float u2 = hash_unit(hash_bits(lo, k.w2, k.w3));
      const float r = __fsqrt_rn(-2.0f * logf(fmaxf(u1, (float)1e-12)));
      return r * cosf((float)6.283185307179586 * u2);
    }
  } else {
    const float u = threefry_unit(threefry_bits(k.w0, k.w1, (uint32_t)(c >> 32), lo));
    if constexpr (O == kUniform) {
      return u;
    } else {
      constexpr float kNormalLo = -0.99999994039535522f;  // nextafter(-1, 0)
      const float v = fmaxf(u * 2.0f + kNormalLo, kNormalLo);
      return (float)1.4142135623730951 * erf_inv(v);
    }
  }
}

template <Gen G, Out O>
__global__ void __launch_bounds__(kThreads) rng_kernel(CounterMap m, Words k,
                                                       float* __restrict__ out) {
  const unsigned i0 = (blockIdx.x * kThreads + threadIdx.x) * kPer;
  if (i0 >= m.n) return;
  if (i0 + kPer <= m.n) {
    float v[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) v[e] = draw<G, O>(m, k, i0 + e);
    *reinterpret_cast<float4*>(out + i0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (unsigned i = i0; i < m.n; ++i) out[i] = draw<G, O>(m, k, i);
  }
}

template <Gen G, Out O>
cudaError_t launch(const CounterMap& m, const Words& k, float* out, cudaStream_t stream) {
  const unsigned groups = (m.n + kPer - 1) / kPer;
  rng_kernel<G, O><<<(groups + kThreads - 1) / kThreads, kThreads, 0, stream>>>(m, k, out);
  return cudaGetLastError();
}

}  // namespace

// out [n] f32 = the draw of generator `gen` (0 hash, 1 threefry) with
// output `kind` (0 uniform, 1 normal) over the counters of the map
// (n, blk, inner, row_stride, off, lanes); w0-w3 as in Words.  out must be
// 16-byte aligned; n < 2^31; lanes, if not null, holds blk / inner int64
// indices.
extern "C" int vt_rng(int gen, int kind, float* out, unsigned n, unsigned blk, unsigned inner,
                      unsigned long long row_stride, unsigned long long off,
                      const long long* lanes, unsigned w0, unsigned w1, unsigned w2,
                      unsigned w3, cudaStream_t stream) {
  if (n == 0) return 0;
  if ((reinterpret_cast<uintptr_t>(out) & 15) != 0) return (int)cudaErrorMisalignedAddress;
  if (blk == 0 || inner == 0 || n >= 0x80000000u) return (int)cudaErrorInvalidValue;
  const CounterMap m{n, blk, inner, row_stride, off, lanes};
  const Words k{w0, w1, w2, w3};
  switch (gen * 2 + kind) {
    case 0: return (int)launch<kHash, kUniform>(m, k, out, stream);
    case 1: return (int)launch<kHash, kNormal>(m, k, out, stream);
    case 2: return (int)launch<kThreefry, kUniform>(m, k, out, stream);
    case 3: return (int)launch<kThreefry, kNormal>(m, k, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
