"""Differentiable (relaxed) voxel rendering (counterpart of
voxtracer/diff/volumetric.py).

The same voxel worlds as the hard renderer, rendered through an
exp-transmittance march

    T_k = exp(-sum_{j<k} sigma_j dt),  C = sum_k T_k (1 - exp(-sigma_k dt)) c_k
          + T_final * background

with sigma = softplus(density_logits) * scale, differentiable in the
per-voxel density logits and the 256-entry albedo table (``DiffParams``).

Gradients come from torch autograd.  The four gathers whose adjoints the
JAX package writes by hand are autograd Functions here:

* albedo rows and brick-sigma rows: ``kernels.lookup.LookupRows`` (the
  row-lookup kernel forward, its scatter-add kernel backward on the card);
* the active-ray un-compaction: ``_PermRows`` (backward: the gather by the
  inverse permutation);
* the per-sample cell rows: ``_CellFetch`` (backward: a 1-D ``index_add_``
  into the flat density).

The JAX adjoints of the albedo and brick-sigma rows round the cotangent to
bf16 for the TPU's matrix unit; here they accumulate in f32, so those
gradients agree with the JAX package's to about 0.4%, not bit for bit.

The union-span march's transmittance clamp is one nearest traversal
(``kernels.traverse.traverse``: the nearest-hit kernel on the card, the
plain dense walk on the CPU).  With ``importance=P`` the union core's
nodes are placed by the inverse CDF of a P-segment brick-occupancy
profile; the profile's probes read the brick means through the row-lookup
kernel without autograd (``kernels.lookup.lookup_rows``).

The host helpers (``active_ray_permutation``, ``span_cells_bins``,
``max_aabb_crossings``) stay numpy, written as the JAX package writes
them, so their permutations are bit-equal to its.

``VOXTRACER_DIFF_REMAT=1`` (read at import into ``_REMAT``) runs each
step of the dense per-pair scan under ``torch.utils.checkpoint``: the
backward re-runs the step's forward, a second cell-row gather and
albedo lookup included, instead of keeping its activations.  The six
``_ABLATE_*`` flags, read when a march runs, each remove one stage to
measure its share of the gradient's time; all are off unless set.  The
JAX functions' unused arguments are dropped:
``key`` of render_diff and mse_loss, ``cfg`` of render_diff_active and
mse_loss_active.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from vtbench.reference.core.types import MAT_NONE, Scene, _Record
from vtbench.reference.kernels import lookup
from vtbench.reference.kernels.lookup import LookupRows
from vtbench.reference.kernels.traverse import traverse
from vtbench.reference.render.camera import primary_rays, primary_rays_np
from vtbench.reference.render.integrator import _vol_args
from vtbench.reference.render.sky import sample_sky

F32 = torch.float32
I32 = torch.int32
BIG = 1e34
SEG_CHUNK = 32  # core steps per batched segment: bounds the [C, N] intermediates

# rematerialise the dense per-pair scan in backward: each step's
# activations are recomputed (one more forward, a second cell-row gather
# and albedo lookup) instead of stored.  The union-span march bounds its
# activations by SEG_CHUNK instead and is not affected.  Off by default.
_REMAT = False  # the stored march (the program's default)

# profiling-only ablations: each zeroes one adjoint or skips one forward
# stage, to measure its share of the gradient's time.  Never set outside
# profiling.
_ABLATE_CELL_SCATTER = False  # zero density scatter in _CellFetch's backward
_ABLATE_BSIG_ADJ = False      # zero brick-sigma adjoint
_ABLATE_CLAMP = False         # skip the transmittance-clamp nearest pass
_ABLATE_SPANS = False         # raw AABB intervals instead of occupied spans
_ABLATE_CELL_FETCH = False    # constant rows instead of the per-cell gather
_ABLATE_ALB_FETCH = False     # constant albedo instead of the per-step lookup


@dataclass
class DiffParams(_Record):
    """The trainable leaves."""

    density_logits: torch.Tensor  # [V, G, G, G] f32
    albedo_table: torch.Tensor    # [256, 3] f32


def params_from_scene(scene: Scene, occupied_logit=6.0, empty_logit=-6.0) -> DiffParams:
    occ = scene.volumes.grids != MAT_NONE
    logits = torch.where(occ, occupied_logit, empty_logit).to(F32)
    return DiffParams(density_logits=logits,
                      albedo_table=scene.materials.albedo.to(F32).clone())


def softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0), exact above
    x = 20 too (torch's ``F.softplus`` turns linear there)."""
    return torch.logaddexp(x, torch.zeros_like(x))


class _PermRows(torch.autograd.Function):
    """Row gather by a permutation (the active-ray un-compaction): the
    adjoint of y = x[idx] is the gather ct[inv_idx]."""

    @staticmethod
    def forward(ctx, x, idx, inv_idx):
        ctx.save_for_backward(inv_idx)
        return x[idx.long()]

    @staticmethod
    def backward(ctx, ct):
        (inv_idx,) = ctx.saved_tensors
        return ct[inv_idx.long()], None, None


class _CellFetch(torch.autograd.Function):
    """Clipped [T, 2] row gather (density, material id); the density's
    adjoint is a 1-D index_add_ into dens_flat [T].  The material column
    takes no gradient."""

    @staticmethod
    def forward(ctx, dens_flat, cell_tab, idx):
        ci = torch.clamp(idx.long(), 0, cell_tab.shape[0] - 1)
        ctx.save_for_backward(ci)
        ctx.t = dens_flat.shape[0]
        if _ABLATE_CELL_FETCH:
            return cell_tab.new_ones((ci.shape[0], 2))
        return cell_tab[ci]

    @staticmethod
    def backward(ctx, ct):
        (ci,) = ctx.saved_tensors
        d_dens = torch.zeros(ctx.t, dtype=ct.dtype, device=ct.device)
        if _ABLATE_CELL_SCATTER:
            return d_dens, None, None
        return d_dens.index_add_(0, ci, ct[:, 0]), None, None


class _ConstRows(LookupRows):
    """``_ABLATE_ALB_FETCH``: rows of 0.5 in place of the lookup (no
    kernel launch); the table's gradient is LookupRows' own."""

    @staticmethod
    def forward(ctx, tab, idx):
        ctx.save_for_backward(idx)
        ctx.k = tab.shape[0]
        return tab.new_full((idx.shape[0], tab.shape[1]), 0.5)


class _NoAdjRows(LookupRows):
    """``_ABLATE_BSIG_ADJ``: the row lookup with a zero table gradient."""

    @staticmethod
    def backward(ctx, ct):
        return ct.new_zeros((ctx.k, ct.shape[1])), None


def _rows(table, idx):
    """Albedo rows ``table[clip(idx)]`` [N, C] under autograd (the JAX
    package's ``_rows``): the row-lookup kernel on the card."""
    fn = _ConstRows if _ABLATE_ALB_FETCH else LookupRows
    return fn.apply(table, idx.to(I32).contiguous())


def _bsig_rows(bsig, idx):
    """Per-brick mean sigma ``bsig[clip(idx)]`` [N] under autograd (the JAX
    package's ``_bsig_rows``): the row-lookup kernel on a [K, 1] table."""
    fn = _NoAdjRows if _ABLATE_BSIG_ADJ else LookupRows
    return fn.apply(bsig[:, None], idx.to(I32).contiguous())[:, 0]


def _cell_fetch(dens_flat, cell_tab, idx):
    """[N, 2] cell rows (density, material id), the density's adjoint a 1-D
    scatter (the JAX package's ``_cell_fetch``)."""
    return _CellFetch.apply(dens_flat, cell_tab, idx)


def _clip_cell(x, hi):
    """int32 cell index of float coordinates x, clipped to [0, hi]: the
    cast runs first and the clip catches whatever a cast of a huge or NaN
    coordinate gives (XLA saturates, torch's CPU cast does not)."""
    return torch.minimum(torch.clamp(x.to(I32), min=0), hi)


# World-to-object transforms.  Each rounds as its JAX counterpart does, so
# that a sample on a cell face falls in the same cell in both packages:
# ``_tr`` as the relaxed march's elementwise sums (each product and sum
# rounded on its own), ``_object_rays`` as XLA's CPU dot rounds the
# replay's ``einsum`` (a chain of fused multiply-adds).

def _tr(row, x, point):
    """Row [V, 4] of a batch of transforms applied to x [N, 3] -> [V, N],
    summed in the order x, y, z (+ translation)."""
    c = row[:, None, :]
    out = c[..., 0] * x[:, 0] + c[..., 1] * x[:, 1] + c[..., 2] * x[:, 2]
    return out + c[..., 3] if point else out


def _mat3(m, x):
    """[V, 3, 3] matrices times [N, 3] vectors -> [V, N, 3], rounded as
    XLA's CPU dot rounds ``einsum("vij,nj->vni")``: m_i2 x_2 + (m_i1 x_1 +
    m_i0 x_0), each step a fused multiply-add rounded once.  A product of
    two floats is exact in float64, so each step is one float64 add
    rounded to float32."""
    md = m.double()[:, None]          # [V, 1, 3, 3]
    xd = x.double()[None, :, None]    # [1, N, 1, 3]
    acc = (md[..., 0] * xd[..., 0]).to(F32)
    for j in (1, 2):
        acc = (md[..., j] * xd[..., j] + acc.double()).to(F32)
    return acc


def _object_rays(scene: Scene, o, d):
    """World [N, 3] rays -> per-volume object space ([V, N, 3], [V, N, 3])
    for the replay's segment marches.  The t parameter is shared (affine
    instance transforms keep t linear), so segment bounds in world t apply
    per volume."""
    inv = scene.volumes.inv
    return _mat3(inv[:, :3, :3], o) + inv[:, :3, 3][:, None], _mat3(inv[:, :3, :3], d)


def _occupied_spans(scene: Scene, vox, voy, voz, vdx, vdy, vdz):
    """Per-pair [V, N] (s0, s1): the t-range of occupied-brick crossings of
    each object-space ray, from slab tests against macro groups of 2x2x2
    bricks whose AABBs are tight around their occupied bricks (see the JAX
    package's docstring).  Spans carry no gradient."""
    vols = scene.volumes
    v, n, dev = vols.n, vox.shape[1], vox.device
    mside = round(vols.occ.shape[2] ** (1.0 / 3.0))
    occ_any = (vols.occ[0] != 0).any(-1)  # [V, M3]
    gs_f = vols.gridsize.to(F32)
    cb = vols.cube_min

    gf = 2 if mside % 2 == 0 else 1  # bricks per group edge
    gsd = mside // gf
    g3 = gsd ** 3
    occ7 = occ_any.reshape(v, gsd, gf, gsd, gf, gsd, gf)
    ar = torch.arange(mside, dtype=F32, device=dev)
    bxc = ar.reshape(1, gsd, gf, 1, 1, 1, 1)
    byc = ar.reshape(1, 1, 1, gsd, gf, 1, 1)
    bzc = ar.reshape(1, 1, 1, 1, 1, gsd, gf)
    off = (2, 4, 6)

    def mn(c):
        return torch.where(occ7, c, 1e9).amin(dim=off).reshape(v, g3)

    def mx(c):
        return torch.where(occ7, c + 1.0, -1e9).amax(dim=off).reshape(v, g3)

    lo_b = (mn(bxc), mn(byc), mn(bzc))  # group AABB in brick units
    hi_b = (mx(bxc), mx(byc), mx(bzc))
    occ_g = occ7.sum(dim=off).reshape(v, g3) > 0

    s0 = torch.full((v, n), BIG, dtype=F32, device=dev)
    s1 = torch.full((v, n), -BIG, dtype=F32, device=dev)
    for vi in range(v):
        bs = 8.0 / gs_f[vi]  # brick extent in object units
        rd3 = (1.0 / vdx[vi], 1.0 / vdy[vi], 1.0 / vdz[vi])
        o3 = (vox[vi], voy[vi], voz[vi])
        tmin = torch.full((n, 1), -BIG, dtype=F32, device=dev)
        tmax = torch.full((n, 1), BIG, dtype=F32, device=dev)
        for ax in range(3):
            lo = (cb[vi, ax] + lo_b[ax][vi] * bs)[None, :]  # [1, G3]
            hi = (cb[vi, ax] + hi_b[ax][vi] * bs)[None, :]
            a = (lo - o3[ax][:, None]) * rd3[ax][:, None]
            b = (hi - o3[ax][:, None]) * rd3[ax][:, None]
            ta = torch.minimum(a, b)
            tb = torch.maximum(a, b)
            ta = torch.where(torch.isnan(ta), -BIG, ta)
            tb = torch.where(torch.isnan(tb), BIG, tb)
            tmin = torch.maximum(tmin, ta)
            tmax = torch.minimum(tmax, tb)
        tmin = torch.clamp(tmin, min=0.0)
        hitb = (tmax >= tmin) & occ_g[vi][None, :]
        s0[vi] = torch.where(hitb, tmin, BIG).amin(dim=1)
        s1[vi] = torch.where(hitb, tmax, -BIG).amax(dim=1)
    return s0, s1


def _brick_mean_sigma(params: DiffParams, scene: Scene, density_scale: float):
    """[V * M^3] per-brick mean sigma: a dense reshape-mean, whose adjoint
    is a broadcast (no scatter)."""
    vols = scene.volumes
    v, g = vols.n, vols.pad_size
    mside = round(vols.occ.shape[2] ** (1.0 / 3.0))
    g8 = mside * 8
    sig = softplus(params.density_logits) * density_scale
    if g8 != g:
        sig = F.pad(sig, (0, g8 - g) * 3)
    b = sig.reshape(v, mside, 8, mside, 8, mside, 8)
    return b.mean(dim=(2, 4, 6)).reshape(-1)


def spans_for_rays(scene: Scene, o, d):
    """Occupied-brick spans [V, N] (s0, s1) of world rays o, d [N, 3]: the
    precomputable ``spans`` input of render_diff_active."""
    inv = scene.volumes.inv
    vo = [_tr(inv[:, r], o, True) for r in range(3)]
    vd = [_tr(inv[:, r], d, False) for r in range(3)]
    return _occupied_spans(scene, *vo, *vd)


# --------------------------------------------------------------------------
# Host-side helpers (numpy): camera- and occupancy-derived, loop-invariant
# --------------------------------------------------------------------------

def _band_rays_np(scene: Scene, cfg, row0: int, rows: int):
    """Pixel grids and pinhole rays of `rows` scanlines from row0."""
    h = rows or cfg.height
    x = np.arange(cfg.width, dtype=np.float32)
    y = np.arange(h, dtype=np.float32) + row0
    px, py = np.meshgrid(x, y)
    o, d = primary_rays_np(scene.camera, cfg.width, cfg.height, px.reshape(-1),
                           py.reshape(-1))
    return px, py, o, d


def _object_rays_np(o, d, inv_i):
    return o @ inv_i[:3, :3].T + inv_i[:3, 3], d @ inv_i[:3, :3].T


def _slab_np(oo, dd, lo, hi):
    """Entry and exit t of object rays through the box [lo, hi]."""
    with np.errstate(divide="ignore", invalid="ignore"):
        rd = 1.0 / dd
        a = (lo - oo) * rd
        b = (hi - oo) * rd
    t0 = np.maximum(np.nanmax(np.minimum(a, b), axis=1), 0.0)
    t1 = np.nanmin(np.maximum(a, b), axis=1)
    return t0, t1


def _tile_key(cfg, px, py):
    """8x128-pixel tile order of the pixels (scanline order when the width
    is not a multiple of 128)."""
    if cfg.width % 128 != 0:
        return np.arange(px.size, dtype=np.int64)
    yi, xi = py.reshape(-1).astype(np.int64), px.reshape(-1).astype(np.int64)
    return (((yi // 8) * (cfg.width // 128) + xi // 128) * 1024
            + (yi % 8) * 128 + xi % 128)


def _perm_first(mask, tile_key):
    """Stable permutation putting the rays of `mask` first, each part in
    tile order; and its inverse."""
    perm = np.lexsort((tile_key, ~mask)).astype(np.int32)
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(perm.shape[0], dtype=np.int32)
    return perm, inv_perm


def active_ray_permutation(scene: Scene, cfg, row0: int = 0, rows: int = 0):
    """Stable permutation putting rays that cross any instance AABB first
    (rays outside every AABB render the background exactly).

    Returns (perm int32 [N], inv_perm int32 [N], n_active int)."""
    px, py, o, d = _band_rays_np(scene, cfg, row0, rows)
    inv = scene.volumes.inv.cpu().numpy()
    cb = scene.volumes.cube_min.cpu().numpy()
    valid = np.zeros(o.shape[0], bool)
    for i in range(inv.shape[0]):
        t0, t1 = _slab_np(*_object_rays_np(o, d, inv[i]), cb[i], cb[i] + 1.0)
        valid |= t1 > t0
    perm, inv_perm = _perm_first(valid, _tile_key(cfg, px, py))
    return perm, inv_perm, int(valid.sum())


def span_cells_bins(scene: Scene, cfg, row0: int = 0, rows: int = 0,
                    edges=(4.0, 32.0)):
    """Split the active rays of a band into bins by a span estimate: the
    sum over volumes of the occupied-AABB crossing length in cells.

    Returns a list of (bin_index, perm, inv_perm, n_active), one per
    non-empty bin, shortest spans first; each perm puts that bin's rays in
    the prefix.  Key step counts and the clamp off bin_index, not the list
    position: empty bins are skipped.  The gradients of the per-bin
    renders sum to the full-band gradient."""
    px, py, o, d = _band_rays_np(scene, cfg, row0, rows)
    vols = scene.volumes
    inv = vols.inv.cpu().numpy()
    cb = vols.cube_min.cpu().numpy()
    gs = vols.gridsize.cpu().numpy().astype(np.float32)
    occ_any = (vols.occ[0] != 0).any(-1).cpu().numpy()  # [V, M3]
    mside = round(occ_any.shape[1] ** (1.0 / 3.0))
    n = o.shape[0]
    span_cells = np.zeros(n, np.float32)
    valid = np.zeros(n, bool)
    for i in range(inv.shape[0]):
        # tight AABB of this volume's occupied bricks, in object units
        occ3 = occ_any[i].reshape(mside, mside, mside)
        if not occ3.any():
            continue
        bs = 8.0 / gs[i]
        idx = np.nonzero(occ3)
        lo = cb[i] + np.array([a.min() for a in idx], np.float32) * bs
        hi = cb[i] + np.array([a.max() + 1 for a in idx], np.float32) * bs
        oo, dd = _object_rays_np(o, d, inv[i])
        t0, t1 = _slab_np(oo, dd, lo, hi)
        span_cells += np.maximum(t1 - t0, 0.0) * gs[i]
        # active = crosses an instance AABB (the march's own validity test)
        at0, at1 = _slab_np(oo, dd, cb[i], cb[i] + 1.0)
        valid |= at1 > at0
    bin_id = np.searchsorted(np.asarray(edges, np.float32), span_cells)
    tile_key = _tile_key(cfg, px, py)
    out = []
    for b in range(len(edges) + 1):
        sel = valid & (bin_id == b)
        cnt = int(sel.sum())
        if cnt:
            out.append((b, *_perm_first(sel, tile_key), cnt))
    return out


def max_aabb_crossings(scene: Scene, cfg, row0: int = 0, rows: int = 0) -> int:
    """The most instance AABBs any primary ray of this camera and band
    crosses: the smallest exact `k` for the march's pair compaction."""
    _, _, o, d = _band_rays_np(scene, cfg, row0, rows)
    inv = scene.volumes.inv.cpu().numpy()
    cb = scene.volumes.cube_min.cpu().numpy()
    count = np.zeros(o.shape[0], np.int32)
    for i in range(inv.shape[0]):
        t0, t1 = _slab_np(*_object_rays_np(o, d, inv[i]), cb[i], cb[i] + 1.0)
        count += (t1 > t0).astype(np.int32)
    return int(count.max())


# --------------------------------------------------------------------------
# The march
# --------------------------------------------------------------------------

def _seg_composite(carry, od, ar, ag, ab):
    """Composite a batched segment onto the carry (trans, r, g, b): od
    [S, N] per-step optical depth, ar/ag/ab per-step albedo ([S, N] or
    scalar).  Front-to-back compositing in log space, so one exclusive
    cumsum replaces the per-step recurrence."""
    trans, cr, cg, cb = carry
    cum = torch.cumsum(od, dim=0)            # inclusive prefix
    t_ex = torch.exp(od - cum)               # exclusive prefix product
    w = trans[None] * t_ex * (1.0 - torch.exp(-od))  # [S, N]
    return (trans * torch.exp(-cum[-1]), cr + (w * ar).sum(0),
            cg + (w * ag).sum(0), cb + (w * ab).sum(0))


def _march_color(params: DiffParams, scene: Scene, o, d, n_steps: int,
                 density_scale: float, k: int, span_steps: int, clamp: bool,
                 spans=None, importance: int = 0):
    """The relaxed march over rays o, d [N, 3] -> (color [N, 3], t_total
    [N], valid [N]).  See render_diff for the estimator."""
    n, dev = o.shape[0], o.device
    vols = scene.volumes
    v, g = vols.n, vols.pad_size
    inv = vols.inv  # [V, 4, 4]

    vox, voy, voz = (_tr(inv[:, r], o, True) for r in range(3))   # [V, N]
    vdx, vdy, vdz = (_tr(inv[:, r], d, False) for r in range(3))

    cb = vols.cube_min  # [V, 3]
    bx, by, bz = cb[:, 0:1], cb[:, 1:2], cb[:, 2:3]

    def slab(b0, oc, dc):
        rd = 1.0 / dc
        a = (b0 - oc) * rd
        b = (b0 + 1.0 - oc) * rd
        return torch.minimum(a, b), torch.maximum(a, b)

    t0x, t1x = slab(bx, vox, vdx)
    t0y, t1y = slab(by, voy, vdy)
    t0z, t1z = slab(bz, voz, vdz)
    t0 = torch.maximum(torch.maximum(t0x, t0y), torch.clamp(t0z, min=0.0))
    t1 = torch.minimum(torch.minimum(t1x, t1y), t1z)
    hit = t1 > t0

    if span_steps:
        if _ABLATE_SPANS:
            s0_all, s1_all = torch.where(hit, t0, BIG), torch.where(hit, t1, -BIG)
        elif spans is not None:
            s0_all, s1_all = spans
        else:
            s0_all, s1_all = _occupied_spans(scene, vox, voy, voz, vdx, vdy, vdz)

    valid = hit.any(dim=0)  # [N]
    gs_f = vols.gridsize.to(F32)[:, None]  # [V, 1]
    gs_i = vols.gridsize[:, None]

    if k and k < v:
        # pair compaction: keep the k earliest-entry volumes per ray (a
        # stable sort, so misses keep volume order as jax.lax.sort does)
        key_t = torch.where(hit & ~torch.isnan(t0), t0, 1e30)
        key_s, order = torch.sort(key_t, dim=0, stable=True)
        order = order[:k]

        def srt(x):
            return torch.gather(x, 0, order)

        if span_steps:
            s0_all, s1_all = srt(s0_all), srt(s1_all)
        t1 = srt(torch.where(hit, t1, 0.0))
        hit = srt(hit)
        t0 = key_s[:k]
        vid = order.to(I32)  # [k, N]
        # per-pair volume constants (one [V, 16] row gather per pair)
        vtab = torch.cat([inv[:, :3, :].reshape(v, 12), cb,
                          vols.gridsize.to(F32)[:, None]], dim=1)
        rows16 = vtab[order.reshape(-1)].reshape(k, n, 16)
        iv = [rows16[..., i] for i in range(12)]
        bx, by, bz = rows16[..., 12], rows16[..., 13], rows16[..., 14]
        gs_f = rows16[..., 15]
        gs_i = gs_f.to(I32)
        ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
        dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
        vox = iv[0] * ox + iv[1] * oy + iv[2] * oz + iv[3]
        voy = iv[4] * ox + iv[5] * oy + iv[6] * oz + iv[7]
        voz = iv[8] * ox + iv[9] * oy + iv[10] * oz + iv[11]
        vdx = iv[0] * dx + iv[1] * dy + iv[2] * dz
        vdy = iv[4] * dx + iv[5] * dy + iv[6] * dz
        vdz = iv[8] * dx + iv[9] * dy + iv[10] * dz
        vbase = vid * (g * g * g)
        vol_ids = vid
        v_eff = k
    else:
        vol_ids = torch.arange(v, dtype=I32, device=dev)[:, None].expand(v, n)
        vbase = vol_ids[:, :1] * (g * g * g)
        v_eff = v

    t0p = torch.where(hit, t0, 0.0)  # [v_eff, N]
    dt = torch.where(hit, (t1 - t0) / n_steps, 0.0)
    if span_steps:
        # clamp the occupied span into the pair interval; pairs with no
        # occupied crossing collapse the core and tail to zero length
        s0c = torch.minimum(torch.maximum(s0_all, t0), t1)
        s1c = torch.minimum(torch.maximum(s1_all, s0c), t1)
        no_occ = s0_all > 1e33
        s0c = torch.where(no_occ, t1, s0c)
        s1c = torch.where(no_occ, t1, s1c)
    dens_flat = softplus(params.density_logits).reshape(-1) * density_scale
    # one [T, 2] row per cell: density (differentiable through _CellFetch)
    # and material id (f32, exact for ids <= 255)
    cell_tab = torch.stack([dens_flat.detach(), vols.grids.reshape(-1).to(F32)], dim=1)
    alb_tab = params.albedo_table  # [256, 3]

    def cell_coords(j, t_mid):
        return ((vox[j] + t_mid * vdx[j] - bx[j]) * gs_f[j],
                (voy[j] + t_mid * vdy[j] - by[j]) * gs_f[j],
                (voz[j] + t_mid * vdz[j] - bz[j]) * gs_f[j])

    def in_grid(lx, ly, lz, gsf):
        return ((lx >= 0.0) & (lx < gsf) & (ly >= 0.0) & (ly < gsf)
                & (lz >= 0.0) & (lz < gsf))

    if not span_steps:
        # per-pair scan: each pair marches its own [t0, t1] with n_steps
        # samples, then segments composite front to back by entry t
        def step(ki, trans, cr, cg, cbl):
            t_mid = t0p + (ki + 0.5) * dt
            lx = (vox + t_mid * vdx - bx) * gs_f
            ly = (voy + t_mid * vdy - by) * gs_f
            lz = (voz + t_mid * vdz - bz) * gs_f
            ix, iy, iz = (_clip_cell(c, gs_i - 1) for c in (lx, ly, lz))
            inside = in_grid(lx, ly, lz, gs_f)
            flat = (ix * g + iy) * g + iz + vbase
            cells = _cell_fetch(dens_flat, cell_tab, flat.reshape(-1))
            s = torch.where(inside, cells[:, 0].reshape(v_eff, n), 0.0)
            alb = _rows(alb_tab, cells[:, 1])
            alpha = 1.0 - torch.exp(-s * dt)
            wgt = trans * alpha
            return (trans * (1.0 - alpha), cr + wgt * alb[:, 0].reshape(v_eff, n),
                    cg + wgt * alb[:, 1].reshape(v_eff, n),
                    cbl + wgt * alb[:, 2].reshape(v_eff, n))

        carry = (torch.ones((v_eff, n), dtype=F32, device=dev),
                 *(torch.zeros((v_eff, n), dtype=F32, device=dev) for _ in range(3)))
        for ki in range(n_steps):
            if _REMAT:
                carry = torch.utils.checkpoint.checkpoint(step, ki, *carry, use_reentrant=False)
            else:
                carry = step(ki, *carry)
        trans, cr, cg, cbl = carry
        # prefix transmittance of pair vi: the product over pairs entered
        # strictly earlier (index order on ties)
        order_t = t0p + torch.where(hit, 0.0, 1e30)
        idx_v = torch.arange(v_eff, device=dev)[:, None]
        out = [torch.zeros(n, dtype=F32, device=dev) for _ in range(3)]
        for vi in range(v_eff):
            before = (order_t[vi] > order_t) | ((order_t[vi] == order_t) & (vi > idx_v))
            pf = torch.where(before, trans, 1.0).prod(dim=0)
            out = [out[0] + pf * cr[vi], out[1] + pf * cg[vi], out[2] + pf * cbl[vi]]
        return torch.stack(out, dim=-1), trans.prod(dim=0), valid

    # ---- union-span march: one cell-level march per ray over the union
    # of its pairs' occupied spans; each pair's statically empty lead and
    # tail march span_steps samples at brick granularity against the
    # per-brick mean sigma (dense adjoint)
    m3 = vols.occ.shape[2]
    msp = round(m3 ** (1.0 / 3.0))
    bsig = _brick_mean_sigma(params, scene, density_scale)
    alb_none = alb_tab[MAT_NONE]  # empty bricks carry no material

    u0 = torch.where(hit, s0c, BIG).amin(dim=0)  # [N]
    u1 = torch.where(hit, s1c, -BIG).amax(dim=0)

    # transmittance-bounded upper clamp: past the hard first hit + margin
    # the prefix transmittance is <= exp(-13.8) for the current minimum
    # occupied density, so the core stops there
    if clamp and not _ABLATE_CLAMP:
        occ_cells = vols.grids.reshape(-1) != MAT_NONE
        sig_min = torch.where(occ_cells, dens_flat.detach(), float("inf")).amin()
        margin = 13.8 / torch.clamp(sig_min, min=1e-6) + 1e-3
        rec = traverse(*_vol_args(scene), o.contiguous(), d.contiguous(), None, valid, None,
                       vols.occ, vols.bricksize, mode="nearest")
        t_bound = torch.where(rec["hit"], rec["t"] + margin, BIG)
        u1 = torch.minimum(u1, torch.maximum(t_bound, u0))

    has_core = u1 > u0
    u0 = torch.where(has_core, u0, BIG)  # no-core rays: leads cover all
    u1 = torch.where(has_core, u1, BIG)
    dt_u = torch.where(has_core, (u1 - u0) / n_steps, 0.0)
    if importance > 0:
        # importance-placed core nodes: `importance` probes split [u0, u1]
        # into equal segments; a segment is occupied where its midpoint lies
        # in a pair's grid on a brick whose mean sigma is above 1e-6.  Each
        # segment weighs its occupancy + 0.1 and the nodes sit at the
        # inverse of the weights' CDF, each node's width dt/dc * total /
        # n_steps: the same integral in the changed variable.  No gradient
        # flows through the nodes; the probes read the brick means through
        # the row-lookup kernel.
        imp = importance
        with torch.no_grad():
            bsig1 = bsig[:, None].contiguous()
            segl = (u1 - u0) / imp                                   # [N]
            pj = (torch.arange(imp, dtype=F32, device=dev) + 0.5)[:, None]
            t_probe = u0[None] + pj * segl[None]                     # [P, N]
            occ_p = torch.zeros((imp, n), dtype=torch.bool, device=dev)
            for j in range(v_eff):
                ms_i = (gs_i[j] + 7) // 8
                lx, ly, lz = cell_coords(j, t_probe)
                ibx, iby, ibz = (_clip_cell(c * 0.125, ms_i - 1) for c in (lx, ly, lz))
                fb = (vol_ids[j] * m3 + (ibx * msp + iby) * msp + ibz).expand(imp, n)
                sb = lookup.lookup_rows(bsig1, fb.reshape(-1).to(I32).contiguous())
                occ_p = occ_p | (in_grid(lx, ly, lz, gs_f[j]) & (sb.reshape(imp, n) > 1e-6))
            w_p = occ_p.to(F32) + 0.1                                # [P, N]
            cdf = torch.cumsum(w_p, dim=0)
            total = cdf[-1]
            cstep = ((torch.arange(n_steps, dtype=F32, device=dev) + 0.5)[:, None]
                     * (total[None] / n_steps))                      # [S, N]
            t_tab = u0[None].expand(n_steps, n)
            dt_tab = torch.zeros((n_steps, n), dtype=F32, device=dev)
            prev = torch.zeros(n, dtype=F32, device=dev)
            for j in range(imp):
                in_seg = (cstep >= prev[None]) & (cstep < cdf[j][None])
                frac = (cstep - prev[None]) / w_p[j][None]
                t_tab = torch.where(in_seg, u0[None] + (j + frac) * segl[None], t_tab)
                dt_tab = torch.where(in_seg,
                                     (total[None] / n_steps) * segl[None] / w_p[j][None], dt_tab)
                prev = cdf[j]

    def core_chunk(carry, k0, ksteps):
        if importance > 0:
            t_mid, dtc = t_tab[k0:k0 + ksteps], dt_tab[k0:k0 + ksteps]
        else:
            ki = (torch.arange(ksteps, dtype=F32, device=dev) + (k0 + 0.5))[:, None]
            t_mid, dtc = u0 + ki * dt_u, dt_u  # [C, N]
        flat = torch.zeros((ksteps, n), dtype=I32, device=dev)
        inside_any = torch.zeros((ksteps, n), dtype=torch.bool, device=dev)
        for j in range(v_eff):
            lx, ly, lz = cell_coords(j, t_mid)
            ix, iy, iz = (_clip_cell(c, gs_i[j] - 1) for c in (lx, ly, lz))
            inside = hit[j] & in_grid(lx, ly, lz, gs_f[j])
            f = (ix * g + iy) * g + iz + vbase[j]
            flat = torch.where(inside & ~inside_any, f, flat)
            inside_any = inside_any | inside
        cells = _cell_fetch(dens_flat, cell_tab, flat.reshape(-1))
        s = torch.where(inside_any, cells[:, 0].reshape(ksteps, n), 0.0)
        alb = _rows(alb_tab, cells[:, 1])  # [C * N, 3]
        ar, ag, ab = (torch.where(inside_any, alb[:, c].reshape(ksteps, n), 0.0)
                      for c in range(3))
        return _seg_composite(carry, s * dtc, ar, ag, ab)

    def brick_seg(carry, j, t_start, dtp):
        """Pair j's lead or tail segment at brick granularity."""
        ms_i = (gs_i[j] + 7) // 8
        ki = (torch.arange(span_steps, dtype=F32, device=dev) + 0.5)[:, None]
        t_mid = t_start + ki * dtp  # [S, N]
        lx, ly, lz = cell_coords(j, t_mid)
        ibx, iby, ibz = (_clip_cell(c * 0.125, ms_i - 1) for c in (lx, ly, lz))
        inside = in_grid(lx, ly, lz, gs_f[j])
        flat_b = vol_ids[j] * m3 + (ibx * msp + iby) * msp + ibz
        sb = _bsig_rows(bsig, flat_b.expand(span_steps, n).reshape(-1))
        sb = torch.where(inside, sb.reshape(span_steps, n), 0.0)
        return _seg_composite(carry, sb * dtp, alb_none[0], alb_none[1], alb_none[2])

    carry = (torch.ones(n, dtype=F32, device=dev),
             *(torch.zeros(n, dtype=F32, device=dev) for _ in range(3)))
    for j in range(v_eff):  # leads (all precede the union core)
        lead_hi = torch.minimum(u0, t1[j])
        dtp = torch.where(hit[j], torch.clamp(lead_hi - t0[j], min=0.0) / span_steps, 0.0)
        carry = brick_seg(carry, j, t0[j], dtp)
    for k0 in range(0, n_steps, SEG_CHUNK):
        carry = core_chunk(carry, k0, min(SEG_CHUNK, n_steps - k0))
    for j in range(v_eff):  # tails (all follow the union core)
        tail_lo = torch.maximum(u1, t0[j])
        dtp = torch.where(hit[j], torch.clamp(t1[j] - tail_lo, min=0.0) / span_steps, 0.0)
        carry = brick_seg(carry, j, tail_lo, dtp)
    trans_n, out_r, out_g, out_b = carry
    return torch.stack([out_r, out_g, out_b], dim=-1), trans_n, valid


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------

def render_diff(params: DiffParams, scene: Scene, cfg, n_steps: int = 192,
                density_scale: float = 512.0, row0: int = 0, rows: int = 0,
                k: int = 0, span_steps: int = 0, perm=None, inv_perm=None,
                n_active: int = 0, clamp: bool = True, importance: int = 0):
    """Primary-visibility differentiable render -> [H, W, 3], or
    [rows, W, 3] for the band of `rows` scanlines from row0.

    Each ray x volume pair marches its own AABB interval with n_steps
    samples; segments composite front to back by entry t.  k > 0 keeps
    the k earliest-entry volumes per ray (exact when no ray crosses more
    than k AABBs: max_aabb_crossings).  span_steps > 0 marches one
    n_steps core over the union of the pairs' occupied-brick spans, with
    span_steps brick-level samples over each pair's empty lead and tail,
    and (clamp) stops the core at the hard first hit plus a transmittance
    margin; importance = P > 0 places the core's nodes by P occupancy
    probes a ray instead of uniformly.  perm / inv_perm / n_active
    (active_ray_permutation) march only the active prefix, padded to a
    multiple of 1024 rays."""
    dev = scene.device
    h = rows or cfg.height
    x = torch.arange(cfg.width, dtype=F32, device=dev)
    y = torch.arange(h, dtype=F32, device=dev) + float(row0)
    py, px = torch.meshgrid(y, x, indexing="ij")
    o, d = primary_rays(scene.camera, cfg.width, cfg.height, px.reshape(-1), py.reshape(-1))
    n_full = o.shape[0]
    compact = perm is not None and 0 < n_active < n_full
    if compact:
        # the pad rays past n_active are real inactive rays: their in-march
        # valid=False already renders the background
        na = min(-(-n_active // 1024) * 1024, n_full)
        perm = torch.as_tensor(perm, device=dev).long()
        d_full = d
        o, d = o[perm[:na]], d[perm[:na]]
    color, t_total, valid = _march_color(params, scene, o, d, n_steps, density_scale,
                                         k, span_steps, clamp, importance=importance)
    bg = sample_sky(scene.sky, d, cfg.activate_sky, cfg.sky_fallback)
    img = torch.where(valid[:, None], color + t_total[:, None] * bg, bg)
    if compact:
        tail = sample_sky(scene.sky, d_full[perm[na:]], cfg.activate_sky, cfg.sky_fallback)
        img = _PermRows.apply(torch.cat([img, tail]),
                              torch.as_tensor(inv_perm, device=dev), perm)
    return img.reshape(h, cfg.width, 3)


def render_diff_active(params: DiffParams, scene: Scene, o, d, bg, n_steps: int,
                       density_scale: float = 512.0, k: int = 0, span_steps: int = 0,
                       clamp: bool = True, spans=None, importance: int = 0):
    """Radiance [N, 3] of pre-compacted rays o, d [N, 3] with their
    pre-sampled sky bg [N, 3]: the training-loop form of render_diff, with
    everything camera-derived hoisted out of the gradient."""
    color, t_total, valid = _march_color(params, scene, o, d, n_steps, density_scale,
                                         k, span_steps, clamp, spans=spans,
                                         importance=importance)
    return torch.where(valid[:, None], color + t_total[:, None] * bg, bg)


def mse_loss_active(params: DiffParams, scene: Scene, o, d, bg, target_active,
                    denom: float, n_steps: int, k: int = 0, span_steps: int = 0,
                    clamp: bool = True, n_active: int = 0, spans=None, importance: int = 0):
    """Sum of squared errors over the active rays / denom: with denom the
    full band's element count, exactly the gradient of the band's image
    MSE.  n_active > 0 masks the pad rows past n_active, which may be
    rays of another bin."""
    img = render_diff_active(params, scene, o, d, bg, n_steps, k=k,
                             span_steps=span_steps, clamp=clamp, spans=spans,
                             importance=importance)
    err = ((img - target_active) ** 2).sum(dim=-1)
    if n_active and n_active < o.shape[0]:
        err = torch.where(torch.arange(o.shape[0], device=o.device) < n_active, err, 0.0)
    return err.sum() / denom


def mse_loss(params: DiffParams, scene: Scene, cfg, target, n_steps: int = 192, **march):
    """Mean squared error of render_diff(params, scene, cfg, n_steps,
    **march) against target."""
    img = render_diff(params, scene, cfg, n_steps, **march)
    return ((img - target) ** 2).mean()


def trainable(params: DiffParams) -> DiffParams:
    """Leaves that share params' storage and collect gradients."""
    return DiffParams(density_logits=params.density_logits.detach().requires_grad_(),
                      albedo_table=params.albedo_table.detach().requires_grad_())


def value_and_grad(loss_fn):
    """loss_fn(params, ...) -> a function returning (loss, DiffParams of
    gradients), as jax.value_and_grad; params are not modified."""
    def fn(params: DiffParams, *args, **kwargs):
        leaves = trainable(params)
        loss = loss_fn(leaves, *args, **kwargs)
        gd, ga = torch.autograd.grad(loss, [leaves.density_logits, leaves.albedo_table])
        return loss.detach(), DiffParams(density_logits=gd, albedo_table=ga)
    return fn
