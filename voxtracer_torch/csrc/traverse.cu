// Voxel traversal kernels for Hopper (sm_90a): nearest hit, any hit
// (occlusion) and the material-exit march.
//
// Replaces the TPU kernels of voxtracer/kernels/pallas_dda.py:
//   * traverse_pallas (mode "nearest" and "occluded"), body _make_kernel;
//   * exit_pallas, body _make_exit_kernel.
// The plain PyTorch version is voxtracer_torch/kernels/dda_occ.py
// (traverse_occ); this file reproduces its two-level walk step for step.
//
// What bounds it on the card: the walk is a data-dependent loop per ray,
// so it is bound by latency and warp divergence, not by bytes or FLOPs.
// Its tables are small (a 64^3 grid scene holds 4 x 512 occupancy rows of
// 64 bytes per plane, and the per-volume transforms) and stay in L1/L2.
//
// What the design does about it: one thread per ray, with the whole walk
// in registers.  Each ray visits only the volumes its ray enters, in
// entry-t order, and stops as soon as its best hit lies before the next
// entry; a macro DDA over 8^3 bricks skips empty space with one 64-byte
// row read per brick, and the fine steps inside an occupied brick test
// bits of that row.  Rays are generated in 8x128-pixel tiles upstream, so
// a warp walks neighbouring pixels.  Sorting rays, warp-coherent walks and
// fusing the material lookup into the epilogue are later work.
//
// Precision: build with --fmad=false and without --use_fast_math, so no
// multiply-add is contracted and division and square root are IEEE.  Each
// expression below is written in the same order as the plain version;
// together that makes this kernel agree with the plain version on the
// card bit for bit in hit, vol, cell and t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float BIG = 1e34f;
constexpr int BRICK = 8;
constexpr int INNER = 8;
constexpr int MAX_V = 64;
constexpr int MAT_NONE = 255;
constexpr int MODE_NEAREST = 0;
constexpr int MODE_OCCLUDED = 1;
constexpr int MODE_EXIT = 2;

// NaN-propagating min/max, as torch.minimum/maximum and jnp.minimum/maximum.
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}

// clip(int32(pos), 0, gs - 1); the cast saturates and maps NaN to 0.
__device__ __forceinline__ int cell_index(float pos, int gs) {
  int p = __float2int_rz(pos);
  return min(max(p, 0), gs - 1);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, rdx, rdy, rdz, sx, sy, sz;
};

struct Scene {
  const int* grids;      // [V * G^3]
  const int* gridsize;   // [V]
  const float* inv;      // [V, 4, 4]
  const float* fwd;      // [V, 4, 4]
  const float* cube_min; // [V, 3]
  const int* bricksize;  // [V]
  const int* occ;        // [3, V, M^3, 16]
  int v, side, mside;
};

__device__ __forceinline__ Ray object_ray(const Scene& sc, int vol, float wox,
                                          float woy, float woz, float wdx,
                                          float wdy, float wdz) {
  const float* m = sc.inv + 16 * vol;
  Ray r;
  r.ox = m[0] * wox + m[1] * woy + m[2] * woz + m[3];
  r.oy = m[4] * wox + m[5] * woy + m[6] * woz + m[7];
  r.oz = m[8] * wox + m[9] * woy + m[10] * woz + m[11];
  r.dx = m[0] * wdx + m[1] * wdy + m[2] * wdz;
  r.dy = m[4] * wdx + m[5] * wdy + m[6] * wdz;
  r.dz = m[8] * wdx + m[9] * wdy + m[10] * wdz;
  r.rdx = 1.0f / r.dx;
  r.rdy = 1.0f / r.dy;
  r.rdz = 1.0f / r.dz;
  r.sx = signbit(r.dx) ? 1.0f : 0.0f;
  r.sy = signbit(r.dy) ? 1.0f : 0.0f;
  r.sz = signbit(r.dz) ? 1.0f : 0.0f;
  return r;
}

__device__ __forceinline__ void slab_axis(float b0, float o, float d, float rd,
                                          float& tmin, float& tmax) {
  bool neg = d < 0.0f;
  float lo = neg ? b0 + 1.0f : b0;
  float hi = neg ? b0 : b0 + 1.0f;
  tmin = (lo - o) * rd;
  tmax = (hi - o) * rd;
}

// Cube::Intersect (scene.cpp:166-202), 0 when the origin is inside: the
// entry t of a ray into the cube [b, b + 1].
__device__ __forceinline__ float entry_t(const Ray& r, float bx, float by,
                                         float bz) {
  bool inside = (r.ox >= bx) && (r.ox <= bx + 1.0f) && (r.oy >= by) &&
                (r.oy <= by + 1.0f) && (r.oz >= bz) && (r.oz <= bz + 1.0f);
  if (inside) return 0.0f;
  float tminx, tmaxx, tminy, tmaxy, tminz, tmaxz;
  slab_axis(bx, r.ox, r.dx, r.rdx, tminx, tmaxx);
  slab_axis(by, r.oy, r.dy, r.rdy, tminy, tmaxy);
  slab_axis(bz, r.oz, r.dz, r.rdz, tminz, tmaxz);
  bool miss = (tminx > tmaxy) || (tminy > tmaxx);
  float t0 = nmax(tminx, tminy);
  float t1 = nmin(tmaxx, tmaxy);
  miss = miss || (t0 > tmaxz) || (tminz > t1);
  t0 = nmax(t0, tminz);
  return (miss || (t0 <= 0.0f)) ? BIG : t0;
}

struct Axis {
  int p, step;
  float tdelta, tmax;
};

// Setup3DDDA (scene.cpp:719-749) for one axis at one grid level.
__device__ __forceinline__ Axis setup_axis(float o, float d, float rd,
                                           float sgn, float b0, float t0,
                                           float gs_f, int gs_i, float cell) {
  float pos = gs_f * ((o - b0) + (t0 + 5e-5f) * d);
  float plane = (ceilf(pos) - sgn) * cell;
  float stepf = 1.0f - sgn * 2.0f;
  Axis a;
  a.p = cell_index(pos, gs_i);
  a.step = (int)stepf;
  a.tdelta = cell * stepf * rd;
  a.tmax = (plane - (o - b0)) * rd;
  return a;
}

// scene.cpp:773-801 axis pick, NaN behaviour kept: 0 = x, 1 = y, 2 = z.
__device__ __forceinline__ int pick_axis(float tmx, float tmy, float tmz) {
  bool first = tmx < tmy;
  if (first && (tmx < tmz)) return 0;
  if (!first && (tmy < tmz)) return 1;
  return 2;
}

struct WalkResult {
  bool hit;     // nearest/occluded: a hit before tl; exit: left the medium
  float t_hit;  // t of that cell
  int cell;     // (px * side + py) * side + pz of that cell
  float t_out;  // exit: the t the ray leaves the medium or the grid
};

// One ray through one volume: dda_occ._core for a single pair.  `rows` is
// the volume's first occupancy row in the chosen plane.
template <int MODE>
__device__ WalkResult walk(const Ray& r, float bx, float by, float bz,
                           int gs_i, int ms_i, int side, int mside,
                           const int* __restrict__ rows, float tl,
                           bool ray_active) {
  const bool is_exit = MODE == MODE_EXIT;
  const float gs_f = (float)gs_i;
  const float ms_f = (float)ms_i;
  const float cellw = 1.0f / gs_f;
  const float mcell = 1.0f / ms_f;

  const float t0 = entry_t(r, bx, by, bz);
  const bool valid = t0 < 1e33f;
  // fine-level steps and deltas; the macro level shares the step signs
  Axis fx = setup_axis(r.ox, r.dx, r.rdx, r.sx, bx, t0, gs_f, gs_i, cellw);
  Axis fy = setup_axis(r.oy, r.dy, r.rdy, r.sy, by, t0, gs_f, gs_i, cellw);
  Axis fz = setup_axis(r.oz, r.dz, r.rdz, r.sz, bz, t0, gs_f, gs_i, cellw);
  Axis mx = setup_axis(r.ox, r.dx, r.rdx, r.sx, bx, t0, ms_f, ms_i, mcell);
  Axis my = setup_axis(r.oy, r.dy, r.rdy, r.sy, by, t0, ms_f, ms_i, mcell);
  Axis mz = setup_axis(r.oz, r.dz, r.rdz, r.sz, bz, t0, ms_f, ms_i, mcell);

  WalkResult res;
  res.hit = false;
  res.t_hit = 0.0f;
  res.cell = 0;
  res.t_out = valid ? t0 : 0.0f;

  bool active = ray_active && valid && (is_exit || (t0 < tl));
  float t = t0;
  bool level = false;
  int px = fx.p, py = fy.p, pz = fz.p;
  float tmx = fx.tmax, tmy = fy.tmax, tmz = fz.tmax;
  int mpx = mx.p, mpy = my.p, mpz = mz.p;
  float mtmx = mx.tmax, mtmy = my.tmax, mtmz = mz.tmax;

  for (int outer = 0; active && outer < 1024; ++outer) {
    // one row per iteration: the current brick's 512 occupancy bits
    const int midx = (mpx * mside + mpy) * mside + mpz;
    const int* row = rows + 16 * midx;
    bool descend = false, skip = false;
    if (!level) {
      const int4* r4 = reinterpret_cast<const int4*>(row);
      int any = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int4 w = __ldg(r4 + k);
        any |= w.x | w.y | w.z | w.w;
      }
      descend = any != 0;
      skip = !descend;
    }
    const int blox = mpx * BRICK, bloy = mpy * BRICK, bloz = mpz * BRICK;
    if (descend) {
      // re-seed the fine DDA at t + 5e-5 and clamp it into the brick
      float pos, pln;
      pos = gs_f * ((r.ox - bx) + (t + 5e-5f) * r.dx);
      pln = (ceilf(pos) - r.sx) * cellw;
      px = min(max(cell_index(pos, gs_i), blox), min(blox + BRICK - 1, gs_i - 1));
      tmx = (pln - (r.ox - bx)) * r.rdx;
      pos = gs_f * ((r.oy - by) + (t + 5e-5f) * r.dy);
      pln = (ceilf(pos) - r.sy) * cellw;
      py = min(max(cell_index(pos, gs_i), bloy), min(bloy + BRICK - 1, gs_i - 1));
      tmy = (pln - (r.oy - by)) * r.rdy;
      pos = gs_f * ((r.oz - bz) + (t + 5e-5f) * r.dz);
      pln = (ceilf(pos) - r.sz) * cellw;
      pz = min(max(cell_index(pos, gs_i), bloz), min(bloz + BRICK - 1, gs_i - 1));
      tmz = (pln - (r.oz - bz)) * r.rdz;
    }

    bool act_f = level || descend;
    bool go_macro = false;
    if (act_f) {
      for (int k = 0; k < INNER; ++k) {
        const int b = ((px - blox) * 8 + (py - bloy)) * 8 + (pz - bloz);
        const int word = __ldg(row + ((b >> 5) & 15));
        const bool bit = ((word >> (b & 31)) & 1) != 0;
        if (bit && (is_exit || t < tl)) {
          res.hit = true;
          res.t_hit = t;
          res.cell = (px * side + py) * side + pz;
          if (is_exit) res.t_out = t;
          act_f = false;
          break;
        }
        const int ax = pick_axis(tmx, tmy, tmz);
        const float t_new = ax == 0 ? tmx : (ax == 1 ? tmy : tmz);
        int moved, blo;
        if (ax == 0) {
          px += fx.step; tmx = tmx + fx.tdelta; moved = px; blo = blox;
        } else if (ax == 1) {
          py += fy.step; tmy = tmy + fy.tdelta; moved = py; blo = bloy;
        } else {
          pz += fz.step; tmz = tmz + fz.tdelta; moved = pz; blo = bloz;
        }
        const bool out_grid = (moved < 0) || (moved >= gs_i);
        const bool out_brick = (moved < blo) || (moved >= blo + BRICK);
        t = t_new;
        if (!is_exit && !(t_new < tl)) { act_f = false; break; }
        if (is_exit && out_grid) res.t_out = t_new;
        if (out_brick && !out_grid) go_macro = true;
        if (out_grid || out_brick) { act_f = false; break; }
      }
    }

    const bool was_fine = level || descend;
    if (was_fine) active = act_f || go_macro;
    level = was_fine && act_f;

    // macro advance: empty-brick skips and fine walks that left a brick
    if (skip || go_macro) {
      const int ax = pick_axis(mtmx, mtmy, mtmz);
      const float mt_new = ax == 0 ? mtmx : (ax == 1 ? mtmy : mtmz);
      int mmoved;
      if (ax == 0) {
        mpx += fx.step; mtmx = mtmx + mx.tdelta; mmoved = mpx;
      } else if (ax == 1) {
        mpy += fy.step; mtmy = mtmy + my.tdelta; mmoved = mpy;
      } else {
        mpz += fz.step; mtmz = mtmz + mz.tdelta; mmoved = mpz;
      }
      const bool m_out = (mmoved < 0) || (mmoved >= ms_i);
      t = mt_new;
      if (is_exit && m_out) res.t_out = mt_new;
      if (m_out) active = false;
      if (!is_exit && !(mt_new < tl)) active = false;
    }
  }
  return res;
}

// GetNormalVoxel (scene.cpp:121-148): object-space face normal at t,
// taken to world space by fwd's linear part.
__device__ __forceinline__ float frac_dist(float o, float dc, float t,
                                           float gs_f) {
  float i1 = (o + t * dc) * gs_f;
  float fg = i1 - floorf(i1);
  return nmin(fg, 1.0f - fg);
}

__device__ void normal_at(const Scene& sc, int vol, const Ray& r, float t,
                          float& nx, float& ny, float& nz) {
  const float gs_f = (float)sc.gridsize[vol];
  float ddx = frac_dist(r.ox, r.dx, t, gs_f);
  float ddy = frac_dist(r.oy, r.dy, t, gs_f);
  float ddz = frac_dist(r.oz, r.dz, t, gs_f);
  float mind = nmin(ddx, nmin(ddy, ddz));
  float ox = ddx == mind ? r.sx * 2.0f - 1.0f : 0.0f;
  float oy = ddy == mind ? r.sy * 2.0f - 1.0f : 0.0f;
  float oz = ddz == mind ? r.sz * 2.0f - 1.0f : 0.0f;
  const float* m = sc.fwd + 16 * vol;
  float wx = m[0] * ox + m[1] * oy + m[2] * oz;
  float wy = m[4] * ox + m[5] * oy + m[6] * oz;
  float wz = m[8] * ox + m[9] * oy + m[10] * oz;
  float inv_len = 1.0f / sqrtf(nmax(wx * wx + wy * wy + wz * wz, 1e-20f));
  nx = wx * inv_len;
  ny = wy * inv_len;
  nz = wz * inv_len;
}

// K1 (nearest) and K2 (occluded): one thread per ray over all volumes.
template <int MODE>
__global__ void __launch_bounds__(128)
traverse_kernel(Scene sc, const float* __restrict__ o,
                const float* __restrict__ d, const float* __restrict__ t_limit,
                const uint8_t* __restrict__ active,
                const uint8_t* __restrict__ vol_enabled, int n,
                uint8_t* __restrict__ hit_out, float* __restrict__ t_out,
                int* __restrict__ vol_out, int* __restrict__ cell_out,
                float* __restrict__ nx_out, float* __restrict__ ny_out,
                float* __restrict__ nz_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float wox = o[3 * i], woy = o[3 * i + 1], woz = o[3 * i + 2];
  const float wdx = d[3 * i], wdy = d[3 * i + 1], wdz = d[3 * i + 2];
  const float tl = t_limit[i];
  const int m3 = sc.mside * sc.mside * sc.mside;
  const int g3 = sc.side * sc.side * sc.side;

  bool best_hit = false;
  float best_t = BIG;
  int best_vol = -2, best_gidx = 0;

  if (active[i]) {
    // candidates in (entry t, volume id) order: a stable insertion sort
    float ts[MAX_V];
    int ids[MAX_V];
    int nc = 0;
    for (int v = 0; v < sc.v; ++v) {
      if (!vol_enabled[v]) continue;
      Ray r = object_ray(sc, v, wox, woy, woz, wdx, wdy, wdz);
      float t0 = entry_t(r, sc.cube_min[3 * v], sc.cube_min[3 * v + 1],
                         sc.cube_min[3 * v + 2]);
      if (!(t0 < 1e33f)) continue;  // missed (or NaN): never walked
      int j = nc++;
      while (j > 0 && ts[j - 1] > t0) {
        ts[j] = ts[j - 1];
        ids[j] = ids[j - 1];
        --j;
      }
      ts[j] = t0;
      ids[j] = v;
    }
    for (int k = 0; k < nc; ++k) {
      // a candidate entering after the best hit (or t_limit) cannot win;
      // neither can any later one
      if (!(ts[k] <= nmin(tl, best_t))) break;
      // the walk limit sits strictly above best_t so an exact-t tie in a
      // later volume is still recorded and loses the earliest-volume
      // tie-break below
      const float bound = nmin(tl, __int_as_float(__float_as_int(best_t) + 1));
      const int v = ids[k];
      Ray r = object_ray(sc, v, wox, woy, woz, wdx, wdy, wdz);
      WalkResult w = walk<MODE>(
          r, sc.cube_min[3 * v], sc.cube_min[3 * v + 1], sc.cube_min[3 * v + 2],
          sc.gridsize[v], sc.bricksize[v], sc.side, sc.mside,
          sc.occ + (size_t)v * m3 * 16, bound, true);
      if (!w.hit) continue;
      if (MODE == MODE_OCCLUDED) {
        best_hit = true;
        break;
      }
      if (!best_hit || w.t_hit < best_t || (w.t_hit == best_t && v < best_vol)) {
        best_hit = true;
        best_t = w.t_hit;
        best_vol = v;
        best_gidx = v * g3 + w.cell;
      }
    }
  }
  hit_out[i] = best_hit ? 1 : 0;
  if (MODE == MODE_OCCLUDED) return;
  float nx = 0.0f, ny = 0.0f, nz = 0.0f;
  if (best_hit) {
    Ray r = object_ray(sc, best_vol, wox, woy, woz, wdx, wdy, wdz);
    normal_at(sc, best_vol, r, best_t, nx, ny, nz);
  }
  t_out[i] = best_hit ? best_t : BIG;
  vol_out[i] = best_hit ? best_vol : -2;
  cell_out[i] = best_hit ? sc.grids[best_gidx] : MAT_NONE;
  nx_out[i] = nx;
  ny_out[i] = ny;
  nz_out[i] = nz;
}

// K3: march each ray through its own volume until it leaves the medium
// (glass plane 1 or smoke plane 2) or the grid.
__global__ void __launch_bounds__(128)
exit_kernel(Scene sc, const float* __restrict__ o, const float* __restrict__ d,
            const uint8_t* __restrict__ active,
            const int* __restrict__ mode_code,
            const int* __restrict__ vol_match, int n,
            uint8_t* __restrict__ in_out, float* __restrict__ t_out,
            int* __restrict__ cell_out, float* __restrict__ nx_out,
            float* __restrict__ ny_out, float* __restrict__ nz_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int v = vol_match[i];
  bool in_vol = false;
  float t = 0.0f, nx = 0.0f, ny = 0.0f, nz = 0.0f;
  int cell = MAT_NONE;
  if (v >= 0 && v < sc.v) {
    const int m3 = sc.mside * sc.mside * sc.mside;
    const int plane = mode_code[i] == 1 ? 2 : 1;  // EXIT_SMOKE -> OCC_EXIT_SMOKE
    Ray r = object_ray(sc, v, o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                       d[3 * i + 1], d[3 * i + 2]);
    WalkResult w = walk<MODE_EXIT>(
        r, sc.cube_min[3 * v], sc.cube_min[3 * v + 1], sc.cube_min[3 * v + 2],
        sc.gridsize[v], sc.bricksize[v], sc.side, sc.mside,
        sc.occ + ((size_t)plane * sc.v + v) * m3 * 16, BIG, active[i] != 0);
    in_vol = w.hit;
    t = w.t_out;
    if (in_vol) {
      normal_at(sc, v, r, t, nx, ny, nz);
      cell = sc.grids[v * sc.side * sc.side * sc.side + w.cell];
    }
  }
  in_out[i] = in_vol ? 1 : 0;
  t_out[i] = t;
  cell_out[i] = cell;
  nx_out[i] = nx;
  ny_out[i] = ny;
  nz_out[i] = nz;
}

inline unsigned blocks_for(int n) { return (unsigned)((n + 127) / 128); }

}  // namespace

extern "C" {

// mode: 0 nearest, 1 occluded.  In occluded mode only hit_out is written.
int vt_traverse(int mode, const float* o, const float* d, const float* t_limit,
                const uint8_t* active, const uint8_t* vol_enabled,
                const int* grids, const int* gridsize, const float* inv,
                const float* fwd, const float* cube_min, const int* bricksize,
                const int* occ, int n, int v, int side, int mside,
                uint8_t* hit_out, float* t_out, int* vol_out, int* cell_out,
                float* nx_out, float* ny_out, float* nz_out,
                cudaStream_t stream) {
  if (v > MAX_V) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Scene sc{grids, gridsize, inv, fwd, cube_min, bricksize, occ, v, side, mside};
  if (mode == MODE_NEAREST) {
    traverse_kernel<MODE_NEAREST><<<blocks_for(n), 128, 0, stream>>>(
        sc, o, d, t_limit, active, vol_enabled, n, hit_out, t_out, vol_out,
        cell_out, nx_out, ny_out, nz_out);
  } else {
    traverse_kernel<MODE_OCCLUDED><<<blocks_for(n), 128, 0, stream>>>(
        sc, o, d, t_limit, active, vol_enabled, n, hit_out, t_out, vol_out,
        cell_out, nx_out, ny_out, nz_out);
  }
  return (int)cudaGetLastError();
}

int vt_exit_march(const float* o, const float* d, const uint8_t* active,
                  const int* mode_code, const int* vol_match, const int* grids,
                  const int* gridsize, const float* inv, const float* fwd,
                  const float* cube_min, const int* bricksize, const int* occ,
                  int n, int v, int side, int mside, uint8_t* in_out,
                  float* t_out, int* cell_out, float* nx_out, float* ny_out,
                  float* nz_out, cudaStream_t stream) {
  if (n == 0) return 0;
  Scene sc{grids, gridsize, inv, fwd, cube_min, bricksize, occ, v, side, mside};
  exit_kernel<<<blocks_for(n), 128, 0, stream>>>(sc, o, d, active, mode_code,
                                                 vol_match, n, in_out, t_out,
                                                 cell_out, nx_out, ny_out,
                                                 nz_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
