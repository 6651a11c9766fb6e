// The path bounce's shading on Hopper (sm_90a): three launches a bounce.
//
// Replaces no Pallas kernel.  On the TPU, XLA fuses the elementwise work
// of voxtracer/render/integrator.py::_bounce_core; the port first ran it
// as plain torch ops on component tuples (voxtracer_torch/render/
// integrator.py::_bounce_core_plain), about 580 launches a bounce, each
// reading and writing [n] floats.  Here the same work is three kernels,
// split where a hand-written kernel has to run in between:
//   bounce_hit       after the nearest traversal (K1) and the material-row
//                    lookup (K4): the deferred sky of a miss, the adopted
//                    inside-glass flag, the emissive add, the medium
//                    march's mask and code (for K3);
//   bounce_nee       after the exit march (K3, where any ray marches): the
//                    exit or fell-off-the-grid hit point, the lobe choice,
//                    and the shadow rays of the NEE (and of the light kill),
//                    written as K2 takes them: the random light, or with
//                    deterministic lights every light;
//   bounce_continue  after the shadow traversals (K2): the light gathered,
//                    the NEE add and the light-kill flag, the continuation
//                    of every material class, the throughput and the new
//                    state, written in place.
// The draws come from csrc/rng.cu before the first kernel (they depend on
// the bounce's key and the lanes alone).  voxtracer_torch/kernels/
// bounce.py launches the kernels and holds their plain versions
// (hit_plain, nee_plain, continue_plain).
//
// The state is the packed path state of the integrator (_pack_path): a
// [21 or 22, n] float32 matrix, a component a row, rows `stride` floats
// apart (a chunk of a wider wavefront is a column window of it).  A ray
// that is not active is left as it is.
//
// Bit for bit the plain ops on the card.  Every float operation is the one
// a torch op performs there, in the same order and each rounded to
// float32: the build has no fast math and --fmad=false, so no product is
// fused into an add.  Rules that follow torch's CUDA kernels:
//   scalar / tensor   torch computes reciprocal(tensor) * scalar: 1.0f / x;
//   tensor / scalar   never used here;
//   a Python scalar   converted from double to float: (float)(expr) of the
//                     same double expression;
//   torch.clamp       keeps NaN (fminf / fmaxf would drop it);
//   rsqrt, sin, cos, exp, sqrt   rsqrtf, sinf, cosf, expf, sqrtf;
//   x.to(int32)       truncation with saturation: __float2int_rz;
//   mathx.offset_ray  an integer step of the float's bits, wrapping.
//
// What bounds it on this card: bytes.  About 80 float operations and two
// transcendental calls (sinf, cosf; expf) a ray against some 300 bytes
// read and written a ray over the three kernels; at 1080p ~0.6 GB, 0.2 ms
// at 3.35 TB/s.  One thread a ray; rays of a row are adjacent, so every
// row access of a warp is one coalesced 128-byte line.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// material classes (voxtracer_torch/core/types.py)
constexpr int MAT_NONE = 255, METAL_HIGH = 5, METAL_LOW = 7, GLASS = 8, SMOKE_LOW = 9,
              SMOKE_PLAYER = 14, EMISSIVE = 15;
// exit march codes (voxtracer_torch/kernels/dda.py)
constexpr int EXIT_GLASS = 0, EXIT_SMOKE = 1;
// rows of the packed state (integrator._pack_path)
constexpr int R_O = 0, R_D = 3, R_TP = 6, R_RAD = 9, R_GL = 12, R_ACT = 13, R_SKY_TP = 15,
              R_SKY_D = 18, R_LK = 21;

// One bounce's buffers; the same struct for all three kernels
// (voxtracer_torch/kernels/bounce.py CArgs mirrors it field for field).
struct Args {
  float* pk;            // the packed state [rows, stride]
  long long stride;     // floats between rows
  int n;                // rays
  int has_lk;           // the state carries in_light (row 21)
  // the nearest hit (find_nearest_world); t and the normal are
  // overwritten by bounce_nee with the exit's
  float* t;
  const int* mat;
  const int* vol;
  float* nx;
  float* ny;
  float* nz;
  const uint8_t* prim_adopt;
  const uint8_t* prim_inside;
  const float* mrow;    // [n, 6]: albedo, roughness, emissive, ior
  // bounce_hit -> K3
  uint8_t* march;
  int* mode;
  // K3 (null where no ray marched)
  const uint8_t* in_vol;
  const float* t_exit;
  const float* ex_nx;
  const float* ex_ny;
  const float* ex_nz;
  // the draws: [n] or [k, n]
  const float* u_lobe;
  const float* u_nee;   // the random light's pick (null with det)
  const float* g_nee;   // its area sample (null with det or without area lights)
  const float* u_lk;    // the light kill's (null without it)
  const float* g_lk;
  const float* g_det;   // det: [n_area * samples, 3, n], area light k's sample j at
  const float* g_det_lk;  // row k * samples + j (null without area lights)
  const float* u_sph;
  const float* g_hemi;
  const float* u_f;
  const float* u_s;
  const float* g_oct;
  // the lights (core/types.py Lights)
  const float* point_pos;
  const float* point_color;
  const float* area_pos;
  const float* area_color;
  const float* area_mult;
  const float* area_radius;
  const float* spot_pos;
  const float* spot_dir;
  const float* spot_color;
  const float* spot_cos;
  const float* dir_direction;
  const float* dir_color;
  int n_point;
  int n_area;
  int n_spot;
  int det;              // cfg.deterministic_lights: every light, not a random one
  int samples;          // det: cfg.num_area_samples
  float inv_samples;    // det: (float)(1.0 / samples)
  float kill_threshold;
  // bounce_nee -> K2 and continue: a shadow ray a segment, segment-major
  // (segment s of ray i at s * n + i): one segment, the random light; with
  // det, each light in turn, points, area lights (`samples` each), spots,
  // the directional light.  The light kill's share the origins.
  float* sh_o;          // [nseg * n, 3]: the offset hit point, every segment
  float* sh_d;          // [nseg * n, 3]
  float* sh_t;
  uint8_t* need;
  float* nee_val;       // [nseg, 3, n]: a segment's contribution where lit
  float* lk_d;
  float* lk_t;
  uint8_t* lk_need;
  float* lk_val;
  uint8_t* go_diffuse;
  uint8_t* nee_mask;
  // K2
  const uint8_t* occ;
  const uint8_t* lk_occ;
  // bounce_continue: the flags as bool rows
  uint8_t* out_in_glass;
  uint8_t* out_active;
  uint8_t* out_in_light;
};

__device__ __forceinline__ float* row(const Args& a, int r) { return a.pk + r * a.stride; }

// torch.clamp(x, max=hi) / (x, min=lo): NaN passes through
__device__ __forceinline__ float clamp_max(float x, float hi) { return isnan(x) ? x : fminf(x, hi); }
__device__ __forceinline__ float clamp_min(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }

// integrator.cdot: x, then y, then z
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

// integrator.cunit
__device__ __forceinline__ void unit3(float& x, float& y, float& z) {
  const float s = rsqrtf(clamp_min(dot3(x, y, z, x, y, z), (float)1e-20));
  x = s * x;
  y = s * y;
  z = s * z;
}

// mathx.offset_ray
__device__ __forceinline__ float offset_ray(float p, float n) {
  const int of_i = __float2int_rz(256.0f * n);
  const unsigned step = p < 0.0f ? 0u - (unsigned)of_i : (unsigned)of_i;
  const float p_i = __uint_as_float(__float_as_uint(p) + step);
  return fabsf(p) < (float)(1.0 / 32.0) ? p + (float)(1.0 / 65536.0) * n : p_i;
}

// mathx.pow5, schlick, schlick_nonmetal
__device__ __forceinline__ float pow5(float x) {
  const float x2 = x * x;
  return x * (x2 * x2);
}
__device__ __forceinline__ float schlick(float cosine, float ior) {
  const float q = (1.0f - ior) / (ior + 1.0f);
  const float r0 = q * q;
  return r0 + (1.0f - r0) * pow5(1.0f - cosine);
}
__device__ __forceinline__ float schlick_nonmetal(float cosine) {
  return (float)0.04 + (float)(1.0 - 0.04) * pow5(1.0f - cosine);
}

// integrator.coctant_dir
__device__ __forceinline__ void octant_dir(float gx, float gy, float gz, float& x, float& y,
                                           float& z) {
  x = fabsf(gx) + (float)1e-12;
  y = fabsf(gy) + (float)1e-12;
  z = fabsf(gz) + (float)1e-12;
  unit3(x, y, z);
}

struct Light {
  float dx, dy, dz;  // the shadow ray's direction
  float t;           // its length
  float ix, iy, iz;  // the intensity
  bool gate;
};

// illumination's terms of one light at hit point p with normal n, as both
// its branches compute them (_det_illumination and the random branch)
__device__ __forceinline__ Light toward(const float* lp, float px, float py, float pz) {
  Light l;
  const float tx = lp[0] - px, ty = lp[1] - py, tz = lp[2] - pz;
  l.t = sqrtf(dot3(tx, ty, tz, tx, ty, tz));
  const float r = 1.0f / l.t;
  l.dx = r * tx;
  l.dy = r * ty;
  l.dz = r * tz;
  return l;
}

__device__ Light point_light(const Args& a, int k, float px, float py, float pz, float nx,
                             float ny, float nz) {
  Light l = toward(a.point_pos + 3 * k, px, py, pz);
  const float* lc = a.point_color + 3 * k;
  const float cos_t = dot3(l.dx, l.dy, l.dz, nx, ny, nz);
  const float s = cos_t / (l.t * l.t);
  l.ix = s * lc[0];
  l.iy = s * lc[1];
  l.iz = s * lc[2];
  l.gate = cos_t > 0.0f;
  return l;
}

// g: the sample's normal draw [3, n] at ray i of n
__device__ Light area_light(const Args& a, int k, const float* g, int i, float px, float py,
                            float pz, float nx, float ny, float nz) {
  const float* lp = a.area_pos + 3 * k;
  const float* lc = a.area_color + 3 * k;
  const float lmul = a.area_mult[k], lrad = a.area_radius[k];
  float rx, ry, rz;
  octant_dir(g[i], g[a.n + i], g[2 * a.n + i], rx, ry, rz);
  const float target[3] = {lrad * rx + lp[0], lrad * ry + lp[1], lrad * rz + lp[2]};
  Light l = toward(target, px, py, pz);
  const float cos_t = dot3(l.dx, l.dy, l.dz, nx, ny, nz);
  const float s = cos_t * lmul * lrad * lrad * (float)(4.0 * 3.141592653589793) / (l.t * l.t);
  l.ix = s * lc[0];
  l.iy = s * lc[1];
  l.iz = s * lc[2];
  l.gate = cos_t > 0.0f;
  return l;
}

__device__ Light spot_light(const Args& a, int k, float px, float py, float pz) {
  Light l = toward(a.spot_pos + 3 * k, px, py, pz);
  const float* ld = a.spot_dir + 3 * k;
  const float* lc = a.spot_color + 3 * k;
  const float lcos = a.spot_cos[k];
  const float cos_t = dot3(l.dx, l.dy, l.dz, ld[0], ld[1], ld[2]);
  const float alpha = 1.0f - (1.0f - cos_t) / (1.0f - lcos);
  const float s = cos_t / (l.t * l.t) * alpha;
  l.ix = s * lc[0];
  l.iy = s * lc[1];
  l.iz = s * lc[2];
  l.gate = cos_t > lcos;
  return l;
}

// the directional light; a black one (the reference default) contributes
// zero whatever the occlusion says: no shadow ray for it
__device__ Light dir_light(const Args& a, float nx, float ny, float nz) {
  const float* dd = a.dir_direction;
  const float* dc = a.dir_color;
  Light l;
  l.dx = -dd[0];
  l.dy = -dd[1];
  l.dz = -dd[2];
  const float cos_d = dot3(l.dx, l.dy, l.dz, nx, ny, nz);
  l.ix = cos_d * dc[0];
  l.iy = cos_d * dc[1];
  l.iz = cos_d * dc[2];
  l.t = (float)1e34;
  l.gate = cos_d > 0.0f && (dc[0] != 0.0f || dc[1] != 0.0f || dc[2] != 0.0f);
  return l;
}

// Segment s of ray i: its shadow ray and contribution v (3 rows of n)
__device__ __forceinline__ void put_segment(const Args& a, int s, int i, const Light& l,
                                            bool mask, float vx, float vy, float vz, float* d,
                                            float* t, uint8_t* need, float* v) {
  const size_t j = (size_t)s * a.n + i;
  d[3 * j] = l.dx;
  d[3 * j + 1] = l.dy;
  d[3 * j + 2] = l.dz;
  t[j] = l.t;
  need[j] = mask && l.gate;
  v[(size_t)(3 * s) * a.n + i] = vx;
  v[(size_t)(3 * s + 1) * a.n + i] = vy;
  v[(size_t)(3 * s + 2) * a.n + i] = vz;
}

// illumination's shadow rays for the rays of `mask`: the random light u
// picks (one segment; its contribution scaled by the light count), or with
// det every light (integrator._det_illumination's segments)
__device__ void light_segments(const Args& a, int i, bool mask, float u, const float* g,
                               const float* g_det, float px, float py, float pz, float nx,
                               float ny, float nz, const float* alb, float* d, float* t,
                               uint8_t* need, float* v) {
  const int np = a.n_point, na = a.n_area, ns = a.n_spot;
  if (!a.det) {
    const int total = np + na + ns + 1;
    const int idx = min(__float2int_rz(u * (float)total), total - 1);
    const Light l = idx < np ? point_light(a, idx, px, py, pz, nx, ny, nz)
                  : idx < np + na ? area_light(a, idx - np, g, i, px, py, pz, nx, ny, nz)
                  : idx < np + na + ns ? spot_light(a, idx - np - na, px, py, pz)
                  : dir_light(a, nx, ny, nz);
    const float tot = (float)total;
    put_segment(a, 0, i, l, mask, tot * (0.0f + l.ix * alb[0]), tot * (0.0f + l.iy * alb[1]),
                tot * (0.0f + l.iz * alb[2]), d, t, need, v);
    return;
  }
  int s = 0;
  for (int k = 0; k < np; ++k, ++s) {
    const Light l = point_light(a, k, px, py, pz, nx, ny, nz);
    put_segment(a, s, i, l, mask, l.ix * alb[0], l.iy * alb[1], l.iz * alb[2], d, t, need, v);
  }
  for (int k = 0; k < na; ++k) {
    for (int j = 0; j < a.samples; ++j, ++s) {
      const float* gk = g_det + (size_t)(k * a.samples + j) * 3 * a.n;
      const Light l = area_light(a, k, gk, i, px, py, pz, nx, ny, nz);
      put_segment(a, s, i, l, mask, l.ix, l.iy, l.iz, d, t, need, v);
    }
  }
  for (int k = 0; k < ns; ++k, ++s) {
    const Light l = spot_light(a, k, px, py, pz);
    put_segment(a, s, i, l, mask, l.ix * alb[0], l.iy * alb[1], l.iz * alb[2], d, t, need, v);
  }
  const Light l = dir_light(a, nx, ny, nz);
  put_segment(a, s, i, l, mask, l.ix * alb[0], l.iy * alb[1], l.iz * alb[2], d, t, need, v);
}

// The light a ray gathers from its segments once K2 has answered (occ):
// the lit segment's contribution, or with det the sum in the reference's
// order, each area light's samples averaged and times the albedo
__device__ void light_sum(const Args& a, int i, const uint8_t* need, const uint8_t* occ,
                          const float* v, const float* alb, float* acc) {
  const int n = a.n;
  auto lit = [&](int s) { return need[(size_t)s * n + i] && !occ[(size_t)s * n + i]; };
  auto val = [&](int s, int c) { return v[(size_t)(3 * s + c) * n + i]; };
  acc[0] = acc[1] = acc[2] = 0.0f;
  if (!a.det) {
    const bool l = lit(0);
    for (int c = 0; c < 3; ++c) acc[c] = l ? val(0, c) : 0.0f;
    return;
  }
  int s = 0;
  for (int k = 0; k < a.n_point; ++k, ++s) {
    const bool l = lit(s);
    for (int c = 0; c < 3; ++c) acc[c] = acc[c] + (l ? val(s, c) : 0.0f);
  }
  for (int k = 0; k < a.n_area; ++k) {
    float area[3] = {0.0f, 0.0f, 0.0f};
    for (int j = 0; j < a.samples; ++j, ++s) {
      if (lit(s))
        for (int c = 0; c < 3; ++c) area[c] = area[c] + val(s, c);
    }
    for (int c = 0; c < 3; ++c) acc[c] = acc[c] + a.inv_samples * area[c] * alb[c];
  }
  for (int k = 0; k <= a.n_spot; ++k, ++s) {  // the spots, then the directional light
    const bool l = lit(s);
    for (int c = 0; c < 3; ++c) acc[c] = acc[c] + (l ? val(s, c) : 0.0f);
  }
}

__device__ __forceinline__ bool is_smoke(int mat) { return mat >= SMOKE_LOW && mat <= SMOKE_PLAYER; }

__global__ void __launch_bounds__(kThreads) bounce_hit_kernel(Args a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const int mat = a.mat[i];
  const bool glass = mat == GLASS, smoke = is_smoke(mat);
  a.mode[i] = glass ? EXIT_GLASS : EXIT_SMOKE;
  if (!(row(a, R_ACT)[i] > 0.5f)) {
    a.march[i] = 0;
    return;
  }
  const bool in_glass = a.prim_adopt[i] ? a.prim_inside[i] != 0 : row(a, R_GL)[i] > 0.5f;
  row(a, R_GL)[i] = in_glass ? 1.0f : 0.0f;
  if (mat == MAT_NONE) {
    // miss -> sky, terminate; the sky is read once a frame
    for (int c = 0; c < 3; ++c) {
      row(a, R_SKY_TP + c)[i] = row(a, R_TP + c)[i];
      row(a, R_SKY_D + c)[i] = row(a, R_D + c)[i];
    }
    row(a, R_ACT)[i] = 0.0f;
    a.march[i] = 0;
    return;
  }
  if (mat == EMISSIVE) {
    const float emis = a.mrow[6 * i + 4];
    for (int c = 0; c < 3; ++c)
      row(a, R_RAD + c)[i] = row(a, R_RAD + c)[i] + row(a, R_TP + c)[i] * (emis * a.mrow[6 * i + c]);
  }
  a.march[i] = (in_glass && (glass || smoke) && a.vol[i] >= 0) ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads) bounce_nee_kernel(Args a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const int nseg = a.det ? a.n_point + a.n_area * a.samples + a.n_spot + 1 : 1;
  if (!(row(a, R_ACT)[i] > 0.5f)) {
    for (int s = 0; s < nseg; ++s) {
      a.need[(size_t)s * a.n + i] = 0;
      if (a.has_lk) a.lk_need[(size_t)s * a.n + i] = 0;
    }
    a.go_diffuse[i] = 0;
    a.nee_mask[i] = 0;
    return;
  }
  const int mat = a.mat[i];
  float t = a.t[i], nx = a.nx[i], ny = a.ny[i], nz = a.nz[i];
  float ox = row(a, R_O)[i], oy = row(a, R_O + 1)[i], oz = row(a, R_O + 2)[i];
  const float dx = row(a, R_D)[i], dy = row(a, R_D + 1)[i], dz = row(a, R_D + 2)[i];
  if (a.march[i]) {
    t = a.t_exit[i];
    if (a.in_vol[i]) {
      nx = a.ex_nx[i];
      ny = a.ex_ny[i];
      nz = a.ex_nz[i];
    } else {
      // fell off the grid: the origin moves to the boundary, t = 0
      ox = ox + t * dx;
      oy = oy + t * dy;
      oz = oz + t * dz;
      t = 0.0f;
      row(a, R_O)[i] = ox;
      row(a, R_O + 1)[i] = oy;
      row(a, R_O + 2)[i] = oz;
    }
    a.t[i] = t;
    a.nx[i] = nx;
    a.ny[i] = ny;
    a.nz[i] = nz;
  }
  const float px = ox + t * dx, py = oy + t * dy, pz = oz + t * dz;
  const float alb[3] = {a.mrow[6 * i], a.mrow[6 * i + 1], a.mrow[6 * i + 2]};
  const float sx = offset_ray(px, nx), sy = offset_ray(py, ny), sz = offset_ray(pz, nz);
  for (int s = 0; s < nseg; ++s) {
    const size_t j = (size_t)s * a.n + i;
    a.sh_o[3 * j] = sx;
    a.sh_o[3 * j + 1] = sy;
    a.sh_o[3 * j + 2] = sz;
  }
  // the game's light kill: the direct light at a smoke-class hit of
  // volume 0, from its own draws
  if (a.has_lk)
    light_segments(a, i, is_smoke(mat) && a.vol[i] == 0, a.det ? 0.0f : a.u_lk[i], a.g_lk,
                   a.g_det_lk, px, py, pz, nx, ny, nz, alb, a.lk_d, a.lk_t, a.lk_need,
                   a.lk_val);
  // the lobe choice, then the NEE of the diffuse-ish lobes
  const float cos_in = clamp_max(dot3(-dx, -dy, -dz, nx, ny, nz), 1.0f);
  const bool go_diffuse = a.u_lobe[i] > schlick_nonmetal(cos_in);
  const bool nee = (mat < METAL_HIGH && go_diffuse) || (mat > EMISSIVE && mat != MAT_NONE);
  light_segments(a, i, nee, a.det ? 0.0f : a.u_nee[i], a.g_nee, a.g_det, px, py, pz, nx, ny,
                 nz, alb, a.sh_d, a.sh_t, a.need, a.nee_val);
  a.go_diffuse[i] = go_diffuse;
  a.nee_mask[i] = nee;
}

__global__ void __launch_bounds__(kThreads) bounce_continue_kernel(Args a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const bool in_glass = row(a, R_GL)[i] > 0.5f;
  const bool in_light = a.has_lk && row(a, R_LK)[i] > 0.5f;
  if (!(row(a, R_ACT)[i] > 0.5f)) {
    a.out_in_glass[i] = in_glass;
    a.out_active[i] = 0;
    if (a.has_lk) a.out_in_light[i] = in_light;
    return;
  }
  const int mat = a.mat[i];
  const bool metal = mat >= METAL_HIGH && mat <= METAL_LOW, nonmetal = mat < METAL_HIGH,
             glass = mat == GLASS, smoke = is_smoke(mat), emissive = mat == EMISSIVE,
             model = mat > EMISSIVE && mat != MAT_NONE;
  const float* m = a.mrow + 6 * i;
  const float alb[3] = {m[0], m[1], m[2]};
  const float rough = m[3], emis = m[4], ior = m[5];
  float t = a.t[i];
  const float n[3] = {a.nx[i], a.ny[i], a.nz[i]};
  float o[3], d[3], tp0[3], rad[3];
  for (int c = 0; c < 3; ++c) {
    o[c] = row(a, R_O + c)[i];
    d[c] = row(a, R_D + c)[i];
    tp0[c] = row(a, R_TP + c)[i];
    rad[c] = row(a, R_RAD + c)[i];
  }
  const bool go_diffuse = a.go_diffuse[i] != 0, nee = a.nee_mask[i] != 0;

  // the NEE add: nonmetal rad += T * inc; model rad += T * alb * inc
  float inc[3];
  light_sum(a, i, a.need, a.occ, a.nee_val, alb, inc);
  for (int c = 0; c < 3; ++c) {
    if (nee && nonmetal) rad[c] = rad[c] + tp0[c] * inc[c];
    if (nee && model) rad[c] = rad[c] + tp0[c] * (alb[c] * inc[c]);
  }
  bool new_in_light = in_light;
  if (a.has_lk) {
    float lk[3];
    light_sum(a, i, a.lk_need, a.lk_occ, a.lk_val, alb, lk);
    new_in_light = in_light || (smoke && a.vol[i] == 0 &&
                                dot3(lk[0], lk[1], lk[2], lk[0], lk[1], lk[2]) > a.kill_threshold);
  }

  // continuation directions per lobe
  const float dn = dot3(d[0], d[1], d[2], n[0], n[1], n[2]);
  float refl[3], sph[3], spec[3], diff[3], mdl[3];
  for (int c = 0; c < 3; ++c) refl[c] = d[c] - (2.0f * dn) * n[c];
  {
    const float u1 = a.u_sph[i], u2 = a.u_sph[a.n + i], u3 = a.u_sph[2 * a.n + i];
    const float theta = u1 * (float)6.283185307179586;
    const float phi = u2 * (float)3.141592653589793;
    const float sp = sinf(phi);
    sph[0] = u3 * sp * cosf(theta);
    sph[1] = u3 * sp * sinf(theta);
    sph[2] = u3 * cosf(phi);
  }
  for (int c = 0; c < 3; ++c) {
    spec[c] = refl[c] + rough * sph[c];
    diff[c] = n[c] + sph[c];
    mdl[c] = a.g_hemi[c * a.n + i] + (float)1e-12;
  }
  unit3(mdl[0], mdl[1], mdl[2]);
  {
    const float flip = dot3(mdl[0], mdl[1], mdl[2], n[0], n[1], n[2]) < 0.0f ? -1.0f : 1.0f;
    for (int c = 0; c < 3; ++c) mdl[c] = flip * mdl[c];
  }

  // glass: Fresnel reflect or refract
  const float ratio = in_glass ? ior : 1.0f / ior;
  const float cos_g = clamp_max(dot3(-d[0], -d[1], -d[2], n[0], n[1], n[2]), 1.0f);
  const float sin_g = sqrtf(clamp_min(1.0f - cos_g * cos_g, 0.0f));
  const bool do_reflect = ratio * sin_g > 1.0f || schlick(cos_g, ratio) > a.u_f[i];
  float glass_dir[3], glass_norm[3];
  {
    float rp[3];
    for (int c = 0; c < 3; ++c) rp[c] = ratio * (d[c] + cos_g * n[c]);
    const float rpar = -sqrtf(fabsf(1.0f - dot3(rp[0], rp[1], rp[2], rp[0], rp[1], rp[2])));
    for (int c = 0; c < 3; ++c) {
      glass_dir[c] = do_reflect ? refl[c] : rp[c] + rpar * n[c];
      glass_norm[c] = do_reflect ? n[c] : -n[c];
    }
  }
  const bool glass_flip = glass && !do_reflect;

  // smoke: stochastic in-scatter, then the ratio-1 pass-through
  const float intensity = in_glass && smoke ? emis : 0.0f;
  const float dist = a.march[i] ? t : 0.0f;
  const float us0 = a.u_s[i];
  const float thresh = us0 * 100.0f - intensity;
  if (smoke && a.u_s[a.n + i] * dist > thresh) {
    const float scat_t = t * (float)0.45 + us0 * (t - t * (float)0.45);
    for (int c = 0; c < 3; ++c) o[c] = o[c] + scat_t * d[c];
    octant_dir(a.g_oct[i], a.g_oct[a.n + i], a.g_oct[2 * a.n + i], d[0], d[1], d[2]);
    t = 0.0f;
  }

  // the continuation, its origin, the throughput
  float nd[3], off_n[3], tp[3];
  for (int c = 0; c < 3; ++c) {
    float v = d[c];
    if (metal) v = spec[c];
    if (nonmetal && go_diffuse) v = diff[c];
    if (nonmetal && !go_diffuse) v = spec[c];
    if (glass) v = glass_dir[c];
    if (model) v = mdl[c];
    nd[c] = v;
    off_n[c] = smoke ? -n[c] : glass ? glass_norm[c] : n[c];
    tp[c] = tp0[c];
    if (metal || (nonmetal && go_diffuse) || model) tp[c] = tp0[c] * alb[c];
    if (glass) tp[c] = tp0[c] * (in_glass ? alb[c] : 1.0f);
    if (smoke) tp[c] = tp0[c] * expf(-dist * intensity * (1.0f - alb[c]));
  }
  unit3(nd[0], nd[1], nd[2]);
  const bool active = !emissive;
  for (int c = 0; c < 3; ++c) {
    const float p = o[c] + t * d[c];
    row(a, R_O + c)[i] = active ? offset_ray(p, off_n[c]) : o[c];
    row(a, R_D + c)[i] = active ? nd[c] : d[c];
    row(a, R_TP + c)[i] = tp[c];
    row(a, R_RAD + c)[i] = rad[c];
  }
  const bool new_in_glass = (glass_flip || smoke) ? !in_glass : in_glass;
  row(a, R_GL)[i] = new_in_glass ? 1.0f : 0.0f;
  row(a, R_ACT)[i] = active ? 1.0f : 0.0f;
  a.out_in_glass[i] = new_in_glass;
  a.out_active[i] = active;
  if (a.has_lk) {
    row(a, R_LK)[i] = new_in_light ? 1.0f : 0.0f;
    a.out_in_light[i] = new_in_light;
  }
}

}  // namespace

// Stage 0 bounce_hit, 1 bounce_nee, 2 bounce_continue over the rays of
// `args`, an Args, on `stream`.  (void*: a function of a type of the
// anonymous namespace would not be exported.)
extern "C" int vt_bounce(int stage, const void* args, cudaStream_t stream) {
  const Args* a = static_cast<const Args*>(args);
  if (a->n <= 0) return 0;
  const int blocks = (a->n + kThreads - 1) / kThreads;
  switch (stage) {
    case 0: bounce_hit_kernel<<<blocks, kThreads, 0, stream>>>(*a); break;
    case 1: bounce_nee_kernel<<<blocks, kThreads, 0, stream>>>(*a); break;
    case 2: bounce_continue_kernel<<<blocks, kThreads, 0, stream>>>(*a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
