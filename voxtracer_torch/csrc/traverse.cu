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
// so it is bound by issue and latency under warp divergence, not by bytes
// or FLOPs.  On the path's primary rays most of a ray's instructions go to
// the entry tests (object-space ray, three IEEE reciprocals and the slab
// test for every volume), then to the walk's set-up.
//
// What the design does about it: one thread per ray, with the whole walk
// in registers, over tables packed once per scene by kernels/traverse.py
// (scene_tables, world_boxes) and read through the read-only cache:
//   * a [V, 26] constants table in the TPU kernel's vtab order (the
//     inverse transform's rows 0-2, the forward transform's 3x3, cube_min,
//     the grid and brick sizes);
//   * a brick-occupied bitmask per occupancy plane (bit vol * M^3 + brick
//     set iff any of the brick's 512 cell bits is set), so an empty-brick
//     skip tests one bit; a brick's 64-byte cell row is read only on
//     descent, one word per fine step;
//   * each volume's world-space box, widened by a margin: a ray that
//     surely misses the box skips the volume's object-space entry test
//     (the exact test would miss too, so no result changes).
// K1 and K2 visit the volumes in index order and walk each one as soon as
// its entry test passes, with no candidate list: a volume entered after
// the best hit so far (or t_limit) is skipped, and each walk stops just
// above the best hit so far, so the nearest hit and the earliest-volume
// tie-break come out as in (entry t, volume) order; K2 stops at its first
// hit.  Everything a thread keeps stays in registers (no stack frame), at
// any volume count: the one limit is that a cell's index in the stacked
// grids, V * G^3, fits 32 bits (8,191 volumes of 64^3).  A scene past the
// TPU kernels' 64 volumes takes one launch over all of them; a launch a
// page (the TPU's way) was timed against it and lost (PERF.md).
//
// K3 marches a ray through the one volume it names.  A ray that is not
// active, or names no volume, returns at once with in_vol false and
// zeros: no caller reads more of such a lane, and on the path's calls
// most lanes are such.  What is left of a small call is the launch.

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
constexpr int THREADS = 128;
constexpr int MAT_NONE = 255;
constexpr int MODE_NEAREST = 0;
constexpr int MODE_OCCLUDED = 1;
constexpr int MODE_EXIT = 2;
// K1's variants (a compile-time flag set; 0 is the K1 every path launches):
// COUNT writes each ray's outer trips, NO_NORMALS skips the normal epilogue
constexpr int VAR_COUNT = 1;
constexpr int VAR_NO_NORMALS = 2;
// the packed constants table: 26 floats a volume
constexpr int VT = 26, VT_FWD = 12, VT_MIN = 21, VT_GS = 24, VT_MS = 25;

// NaN-propagating min/max, as torch.minimum/maximum and jnp.minimum/maximum:
// PTX's max.NaN / min.NaN (sm_80 on) give the canonical NaN 0x7fffffff when
// either input is NaN, else what fmaxf / fminf give.
__device__ __forceinline__ float nmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// clip(int32(pos), 0, gs - 1); the cast saturates and maps NaN to 0.
__device__ __forceinline__ int cell_index(float pos, int gs) {
  int p = __float2int_rz(pos);
  return min(max(p, 0), gs - 1);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, rdx, rdy, rdz, sx, sy, sz;
};

// The scene as the kernels read it: the packed tables and the raw rows.
struct Tables {
  const float* vtab;     // [V, 26]
  const unsigned* bm;    // [3, words] brick-occupied bits per plane
  const int* occ;        // [3, V, M^3, 16] occupancy rows
  const int* grids;      // [V * G^3] material of each cell
  const float* wbox;     // [V, 8] world box lo xyz, hi xyz, coordinate magnitude, 0
                         // (K1 and K2's cull)
  int v, side, mside, words;
};

// m: a volume's row of the constants table (the inverse's rows 0-2 first).
__device__ __forceinline__ Ray object_ray(const float* m, float wox, float woy,
                                          float woz, float wdx, float wdy,
                                          float wdz) {
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

__device__ __forceinline__ float vol_entry(const Ray& r, const float* m) {
  return entry_t(r, m[VT_MIN], m[VT_MIN + 1], m[VT_MIN + 2]);
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
  int trips;    // outer iterations taken (read by K1's COUNT variant only)
};

// One ray through one volume: dda_occ._core for a single pair.  t0 is the
// ray's entry t into the volume (entry_t), m the volume's constants row,
// bm the plane's brick bitmask with the volume's bricks from bit bit0 on,
// rows the volume's first occupancy row in the plane; each fine step
// reads its word of the row with __ldg.
template <int MODE>
__device__ __forceinline__ WalkResult walk(const Ray& r, float t0,
                                           const float* m, int side, int mside,
                                           const unsigned* bm, int bit0,
                                           const int* __restrict__ rows,
                                           float tl) {
  const bool is_exit = MODE == MODE_EXIT;
  const float bx = m[VT_MIN], by = m[VT_MIN + 1], bz = m[VT_MIN + 2];
  const float gs_f = m[VT_GS];
  const float ms_f = m[VT_MS];
  const int gs_i = (int)gs_f;
  const int ms_i = (int)ms_f;
  const float cellw = 1.0f / gs_f;
  const float mcell = 1.0f / ms_f;

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

  bool active = valid && (is_exit || (t0 < tl));
  float t = t0;
  bool level = false;
  int px = fx.p, py = fy.p, pz = fz.p;
  float tmx = fx.tmax, tmy = fy.tmax, tmz = fz.tmax;
  int mpx = mx.p, mpy = my.p, mpz = mz.p;
  float mtmx = mx.tmax, mtmy = my.tmax, mtmz = mz.tmax;

  int outer = 0;
  for (; active && outer < 1024; ++outer) {
    // the current brick: one bit of the bitmask says whether it is empty
    const int midx = (mpx * mside + mpy) * mside + mpz;
    const int* row = rows + 16 * midx;
    bool descend = false, skip = false;
    if (!level) {
      const int bit = bit0 + midx;
      descend = ((bm[bit >> 5] >> (bit & 31)) & 1u) != 0;
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
  res.trips = outer;
  return res;
}

// GetNormalVoxel (scene.cpp:121-148): object-space face normal at t,
// taken to world space by fwd's linear part (constants row m), scaled by
// rsqrtf as the reference scales it by lax.rsqrt: the plain version's
// torch.rsqrt is rsqrtf on the card, so the two normals are the same bits
// (1/sqrtf differs by an ulp, which a refracted branch can carry into
// another cell).
__device__ __forceinline__ float frac_dist(float o, float dc, float t,
                                           float gs_f) {
  float i1 = (o + t * dc) * gs_f;
  float fg = i1 - floorf(i1);
  return nmin(fg, 1.0f - fg);
}

__device__ __forceinline__ void normal_at(const float* m, const Ray& r, float t,
                                          float& nx, float& ny, float& nz) {
  const float gs_f = m[VT_GS];
  float ddx = frac_dist(r.ox, r.dx, t, gs_f);
  float ddy = frac_dist(r.oy, r.dy, t, gs_f);
  float ddz = frac_dist(r.oz, r.dz, t, gs_f);
  float mind = nmin(ddx, nmin(ddy, ddz));
  float ox = ddx == mind ? r.sx * 2.0f - 1.0f : 0.0f;
  float oy = ddy == mind ? r.sy * 2.0f - 1.0f : 0.0f;
  float oz = ddz == mind ? r.sz * 2.0f - 1.0f : 0.0f;
  const float* f = m + VT_FWD;
  float wx = f[0] * ox + f[1] * oy + f[2] * oz;
  float wy = f[3] * ox + f[4] * oy + f[5] * oz;
  float wz = f[6] * ox + f[7] * oy + f[8] * oz;
  float inv_len = rsqrtf(nmax(wx * wx + wy * wy + wz * wz, 1e-20f));
  nx = wx * inv_len;
  ny = wy * inv_len;
  nz = wz * inv_len;
}

// 1/x to within 1 ulp (MUFU.RCP, denormals flushed): for the cull, whose
// margin is far above that error; inf for 0 and NaN for NaN, as 1/x.
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// False only when the ray surely misses volume v's world box, widened by
// a margin far above the object-space test's rounding: the exact entry
// test would give BIG as well.  Any NaN keeps the volume.
__device__ __forceinline__ bool may_enter(const float* wb, float ox, float oy, float oz,
                                          float rx, float ry, float rz, float omag) {
  const float m = 1e-4f * (1.0f + wb[6] + omag);
  const float ax = (wb[0] - m - ox) * rx, bx = (wb[3] + m - ox) * rx;
  const float ay = (wb[1] - m - oy) * ry, by = (wb[4] + m - oy) * ry;
  const float az = (wb[2] - m - oz) * rz, bz = (wb[5] + m - oz) * rz;
  const float lo = nmax(nmax(nmin(ax, bx), nmin(ay, by)), nmin(az, bz));
  const float hi = nmin(nmin(nmax(ax, bx), nmax(ay, by)), nmax(az, bz));
  return !(lo > hi || hi < 0.0f);
}

// K1 (nearest) and K2 (occluded): one thread per ray over all volumes, in
// index order.  A volume is walked as soon as its entry test passes; one
// entered after the best hit so far (or t_limit) cannot win and is
// skipped, and K2 stops at its first hit.
// out: nearest: t, vol, cell, nx, ny, nz ([n] each, f32 or i32), with
// VAR_COUNT the trips [n] i32, then the hit bytes; occluded: the hit bytes
// alone.  t_limit null means BIG, vol_enabled null every volume.  VAR (K1
// only) selects a variant: VAR_COUNT sums each ray's outer trips over the
// volumes it walks (0 for an inactive ray), VAR_NO_NORMALS writes zero
// normals without the epilogue; hit, t, vol and cell are the same in every
// variant.
template <int MODE, int VAR = 0>
__global__ void __launch_bounds__(THREADS)
traverse_kernel(Tables tb, const float* __restrict__ o,
                const float* __restrict__ d, const float* __restrict__ t_limit,
                const uint8_t* __restrict__ active,
                const uint8_t* __restrict__ vol_enabled, int n,
                void* __restrict__ out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const float wox = o[3 * i], woy = o[3 * i + 1], woz = o[3 * i + 2];
  const float wdx = d[3 * i], wdy = d[3 * i + 1], wdz = d[3 * i + 2];
  const float wrx = rcp_approx(wdx), wry = rcp_approx(wdy), wrz = rcp_approx(wdz);
  const float omag = fmaxf(fabsf(wox), fmaxf(fabsf(woy), fabsf(woz)));
  const float tl = t_limit == nullptr ? BIG : t_limit[i];
  const int m3 = tb.mside * tb.mside * tb.mside;
  const int g3 = tb.side * tb.side * tb.side;

  bool best_hit = false;
  float best_t = BIG;
  int best_vol = -2, best_gidx = 0, trips = 0;
  if (active[i]) {
    for (int v = 0; v < tb.v && !(MODE == MODE_OCCLUDED && best_hit); ++v) {
      if ((vol_enabled != nullptr && vol_enabled[v] == 0) ||
          !may_enter(tb.wbox + 8 * v, wox, woy, woz, wrx, wry, wrz, omag))
        continue;
      const float* m = tb.vtab + v * VT;
      const Ray r = object_ray(m, wox, woy, woz, wdx, wdy, wdz);
      const float t0 = vol_entry(r, m);
      if (!(t0 < 1e33f) || !(t0 <= nmin(tl, best_t))) continue;
      // the walk limit sits strictly above best_t so an exact-t tie in a
      // later volume is still recorded and loses the earliest-volume
      // tie-break; K2's best_t stays BIG, so its limit is t_limit
      const float limit = nmin(tl, __int_as_float(__float_as_int(best_t) + 1));
      WalkResult w = walk<MODE>(r, t0, m, tb.side, tb.mside, tb.bm, v * m3,
                                tb.occ + (size_t)v * m3 * 16, limit);
      if (VAR & VAR_COUNT) trips += w.trips;
      if (w.hit && (MODE == MODE_OCCLUDED || !best_hit || w.t_hit < best_t ||
                    (w.t_hit == best_t && v < best_vol))) {
        best_hit = true;
        best_t = w.t_hit;
        best_vol = v;
        best_gidx = v * g3 + w.cell;
      }
    }
  }
  if (MODE == MODE_OCCLUDED) {
    static_cast<uint8_t*>(out)[i] = best_hit ? 1 : 0;
    return;
  }
  float nx = 0.0f, ny = 0.0f, nz = 0.0f;
  if (!(VAR & VAR_NO_NORMALS) && best_hit) {
    const float* m = tb.vtab + best_vol * VT;
    normal_at(m, object_ray(m, wox, woy, woz, wdx, wdy, wdz), best_t, nx, ny, nz);
  }
  float* of = static_cast<float*>(out);
  int* oi = static_cast<int*>(out);
  of[i] = best_hit ? best_t : BIG;
  oi[(size_t)n + i] = best_hit ? best_vol : -2;
  oi[2 * (size_t)n + i] = best_hit ? tb.grids[best_gidx] : MAT_NONE;
  of[3 * (size_t)n + i] = nx;
  of[4 * (size_t)n + i] = ny;
  of[5 * (size_t)n + i] = nz;
  constexpr int kFields = (VAR & VAR_COUNT) ? 7 : 6;
  if (VAR & VAR_COUNT) oi[6 * (size_t)n + i] = trips;
  reinterpret_cast<uint8_t*>(of + kFields * (size_t)n)[i] = best_hit ? 1 : 0;
}

// K3: march each active ray through its own volume until it leaves the
// medium (glass plane 1 or smoke plane 2) or the grid; tables from global
// memory.  out: t, cell, nx, ny, nz ([n] each), then the in-volume bytes;
// an inactive ray's are 0, MAT_NONE, 0, 0, 0 and false.
__global__ void __launch_bounds__(THREADS)
exit_kernel(Tables tb, const float* __restrict__ o, const float* __restrict__ d,
            const uint8_t* __restrict__ active,
            const int* __restrict__ mode_code,
            const int* __restrict__ vol_match, int n, void* __restrict__ out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int v = active[i] != 0 ? vol_match[i] : -1;
  bool in_vol = false;
  float t = 0.0f, nx = 0.0f, ny = 0.0f, nz = 0.0f;
  int cell = MAT_NONE;
  if (v >= 0 && v < tb.v) {
    const int m3 = tb.mside * tb.mside * tb.mside;
    const int plane = mode_code[i] == 1 ? 2 : 1;  // EXIT_SMOKE -> OCC_EXIT_SMOKE
    const float* m = tb.vtab + v * VT;
    Ray r = object_ray(m, o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                       d[3 * i + 1], d[3 * i + 2]);
    WalkResult w = walk<MODE_EXIT>(
        r, vol_entry(r, m), m, tb.side, tb.mside, tb.bm + (size_t)plane * tb.words,
        v * m3, tb.occ + ((size_t)plane * tb.v + v) * m3 * 16, BIG);
    in_vol = w.hit;
    t = w.t_out;
    if (in_vol) {
      normal_at(m, r, t, nx, ny, nz);
      cell = tb.grids[v * tb.side * tb.side * tb.side + w.cell];
    }
  }
  float* of = static_cast<float*>(out);
  int* oi = static_cast<int*>(out);
  of[i] = t;
  oi[(size_t)n + i] = cell;
  of[2 * (size_t)n + i] = nx;
  of[3 * (size_t)n + i] = ny;
  of[4 * (size_t)n + i] = nz;
  reinterpret_cast<uint8_t*>(of + 5 * (size_t)n)[i] = in_vol ? 1 : 0;
}

// A launch of K1-K3's grid for n rays that does nothing: what a launch
// costs whatever the kernel does (a measuring aid).
__global__ void __launch_bounds__(THREADS) floor_kernel() {}

inline unsigned blocks_for(int n) { return (unsigned)((n + THREADS - 1) / THREADS); }

// A cell's index in the stacked grids, v * side^3 + cell, must fit an int.
inline bool fits(int v, int side) {
  return v >= 1 && side >= 1 && (long long)v * side * side * side <= 2147483647LL;
}

}  // namespace

extern "C" {

// mode: 0 nearest, 1 occluded; variant: 0, or VAR_COUNT or VAR_NO_NORMALS
// in nearest mode.  t_limit and vol_enabled may be null.
int vt_traverse(int mode, int variant, const float* o, const float* d, const float* t_limit,
                const uint8_t* active, const uint8_t* vol_enabled, const float* vtab,
                const unsigned* bm, const int* occ, const int* grids, const float* wbox,
                int n, int v, int side, int mside, int words, void* out,
                cudaStream_t stream) {
  if (!fits(v, side) || (mode != MODE_NEAREST && mode != MODE_OCCLUDED) ||
      (variant != 0 && (mode != MODE_NEAREST ||
                        (variant != VAR_COUNT && variant != VAR_NO_NORMALS))))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Tables tb{vtab, bm, occ, grids, wbox, v, side, mside, words};
  decltype(&traverse_kernel<MODE_NEAREST>) kernel;
  if (mode == MODE_OCCLUDED) kernel = traverse_kernel<MODE_OCCLUDED>;
  else if (variant == 0) kernel = traverse_kernel<MODE_NEAREST>;
  else if (variant == VAR_COUNT) kernel = traverse_kernel<MODE_NEAREST, VAR_COUNT>;
  else kernel = traverse_kernel<MODE_NEAREST, VAR_NO_NORMALS>;
  kernel<<<blocks_for(n), THREADS, 0, stream>>>(tb, o, d, t_limit, active, vol_enabled, n, out);
  return (int)cudaGetLastError();
}

int vt_exit_march(const float* o, const float* d, const uint8_t* active,
                  const int* mode_code, const int* vol_match, const float* vtab,
                  const unsigned* bm, const int* occ, const int* grids,
                  const float* wbox, int n, int v, int side, int mside, int words,
                  void* out, cudaStream_t stream) {
  if (!fits(v, side)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Tables tb{vtab, bm, occ, grids, wbox, v, side, mside, words};
  exit_kernel<<<blocks_for(n), THREADS, 0, stream>>>(tb, o, d, active, mode_code,
                                                     vol_match, n, out);
  return (int)cudaGetLastError();
}

int vt_launch_floor(int n, cudaStream_t stream) {
  if (n == 0) return 0;
  floor_kernel<<<blocks_for(n), THREADS, 0, stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
