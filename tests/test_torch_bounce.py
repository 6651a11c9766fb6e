"""The port's path bounce (``integrator._bounce_core``) on the CPU,
against the JAX package's.

On the card the bounce's shading runs as the three kernels of
csrc/bounce.cu; on any other device their plain versions
(``kernels.bounce.PLAIN``) run in the same order, between the same
traversals, on the same packed state.  Here each bounce of a frame is held
to the JAX package's ``_bounce_core`` on the same state: every material
class, the exit march, each light type, the light kill, threefry draws
and the deterministic lights; a window of lanes is held bit for bit to
the same lanes of the whole wavefront.  Whole frames on the plain,
reordered and compacted loops, with the light kill and the deterministic
lights, are held to the JAX ``trace_path``.  A CPU frame launches no
kernel; the kernels' wrapper refuses CPU tensors, its argument struct is
the kernel's field for field, and no kernel name falls into a family of
the benchmark's roofline.

Both packages render the very same scene arrays (``scene_from_numpy``)
and the JAX references run op by op (``disable_jit``: under jit XLA's
CPU backend contracts multiply-adds, tests/test_torch_render.py).  Each
state component is held by the path frames' rule
(tests/test_torch_options.py): mean absolute difference <= 1e-4 and at
most 1% of rays off by more than 1e-3; the flags are equal on at least
99% of rays."""

import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_options import _hold_path
from test_torch_render import _flatten, _jax_scene
from voxtracer.config import RenderConfig as JaxConfig
from voxtracer.render import integrator as jax_integrator
from voxtracer.scene.instances import VolumeSpec as JaxVolumeSpec
from voxtracer.scene.instances import build_volumes as jax_build_volumes
from voxtracer.scene.lights import make_lights as jax_make_lights
from voxtracer_torch.core.rng import fold_in, make_key
from voxtracer_torch.kernels import bounce
from voxtracer_torch.render import integrator
from voxtracer_torch.scene.convert import scene_from_numpy
from voxtracer_torch.scene.presets import media_path, media_specs, monu_like_path

torch.set_num_threads(1)

CSRC = pathlib.Path(integrator.__file__).resolve().parent.parent / "csrc" / "bounce.cu"
# the packed state's component rows and flag rows
VECTORS = dict(o=bounce.R_O, d=bounce.R_D, tp=bounce.R_TP, rad=bounce.R_RAD,
               sky_tp=bounce.R_SKY_TP, sky_d=bounce.R_SKY_D)
FLAGS = dict(in_glass=bounce.R_GL, active=bounce.R_ACT, in_light=bounce.R_LK)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _rays(scene, cfg):
    py, px = torch.meshgrid(torch.arange(cfg.height, dtype=torch.float32) + 0.5,
                            torch.arange(cfg.width, dtype=torch.float32) + 0.5, indexing="ij")
    return integrator.primary_rays(scene.camera, cfg.width, cfg.height, px.reshape(-1),
                                   py.reshape(-1))


def _both(jscene):
    """A JAX scene -> (it on the device, the port's scene of its arrays)."""
    return jax.tree.map(jnp.asarray, jscene), scene_from_numpy(_flatten(jscene), device="cpu")


def _all_lights():
    """Every light type, the directional one lit."""
    return jax_make_lights(
        point=((0.0, 3.0, -2.0, 6.0, 6.0, 6.0), (1.0, 2.0, 1.0, 2.0, 1.0, 0.5)),
        spot=((-1.0, 2.5, -1.0, 0.3, -0.9, 0.3, 4.0, 4.0, 3.0, 0.6),),
        area=((0.5, 2.0, -1.5, 3.0, 3.0, 3.0, 2.0, 0.4), (-0.5, 1.5, 0.5, 1.0, 2.0, 1.0, 1.0, 0.2)),
        directional=((0.3, -1.0, 0.2), (0.8, 0.7, 0.6)))


def _media_kill(width, height):
    """The media scene with its smoke volume first (the light kill looks
    at volume 0) and the light kill on -> (JAX scene, cfg)."""
    specs = [JaxVolumeSpec(**vars(s)) for s in media_specs()]
    jscene = _jax_scene("media", width, height).replace(
        volumes=jax_build_volumes(specs[-1:] + specs[:-1]))
    cfg = media_path(width, height, bounces=2)[1]
    return jscene, dataclasses.replace(cfg, detect_light_kill=True, light_kill_threshold=0.01)


def _case(name):
    """-> (JAX scene, the port's scene of its arrays, cfg, lanes) of one
    bounce test."""
    lanes = None
    if name.startswith(("media", "det")):
        if name.endswith("kill"):
            jscene, cfg = _media_kill(32, 32)
        else:
            jscene, cfg = _jax_scene("media", 32, 32), media_path(32, 32, bounces=2)[1]
        if name.startswith("det"):
            jscene = jscene.replace(lights=_all_lights())
            cfg = dataclasses.replace(cfg, deterministic_lights=True)
    else:
        jscene = _jax_scene("monu_like", 32, 32)
        cfg = monu_like_path(32, 32, gridsize=16, bounces=2)[1]
        if name == "lights":
            jscene = jscene.replace(lights=_all_lights())
        elif name == "threefry":
            cfg = dataclasses.replace(cfg, rng="threefry")
        elif name == "lanes":  # the 1,024-ray frame as lanes 96 .. 1,119 of 2,048
            lanes = (96, 2048)
    return (*_both(jscene), cfg, lanes)


def _jax_state(pk):
    """The packed state as the JAX package's state dict."""
    c = [jnp.asarray(r.numpy()) for r in pk]
    st = {k: tuple(c[r:r + 3]) for k, r in VECTORS.items()}
    st.update({k: c[r] > 0.5 for k, r in FLAGS.items() if r < len(c)})
    return st


def _hold_state(pk, want, what):
    """The packed state against a JAX state dict: each component by the
    path frames' rule, each flag on at least 99% of rays."""
    for k, r in VECTORS.items():
        _hold_path(pk[r:r + 3].T.numpy(), np.stack([np.asarray(x) for x in want[k]], -1))
    for k, r in FLAGS.items():
        if r < pk.shape[0]:
            same = ((pk[r] > 0.5).numpy() == np.asarray(want[k])).mean()
            assert same >= 0.99, f"{what}: {k} equal on {same:.2%}"


def _window_bounces(scene, cfg, lanes, key):
    """Each bounce of the frame's rays as the window `lanes` = (first,
    total) against the same lanes of a whole wavefront (the frame's rays
    repeated, rolled to start at `first`), bit for bit -> the window's
    (pk, the materials its active rays hit)."""
    first, total = lanes
    o, d = _rays(scene, cfg)
    n = o.shape[0]
    whole, active = integrator._first_path(
        cfg, *(x.repeat(total // n, 1).roll(first, 0) for x in (o, d)))
    pk, win_active = whole[:, first:first + n].clone(), active[first:first + n]
    kinds = set()
    for depth in range(cfg.max_bounces + 1):
        if not bool(active.any()):
            break
        rec = integrator.find_nearest_world(scene, pk[0:3].T, pk[3:6].T, win_active)
        kinds |= set(rec["mat"][win_active].tolist())
        bkey = fold_in(key, depth)
        active = integrator._bounce_core(scene, cfg, whole, active, bkey)
        win_active = integrator._bounce_core(scene, cfg, pk, win_active, bkey, lanes)
        assert torch.equal(_bits(pk), _bits(whole[:, first:first + n])), f"bounce {depth}"
        assert torch.equal(win_active, active[first:first + n])
    return pk, kinds


@pytest.mark.parametrize("name", ["monu", "media", "media_kill", "lights", "threefry", "lanes",
                                  "det", "det_kill"])
def test_bounce_matches_jax(name):
    """Each bounce of a frame: the port's bounce (the plain stages between
    the traversals, in place on the packed state) against the JAX
    package's bounce on the same state.  The JAX bounce draws at lanes 0 ..
    n-1: the window of lanes is held to the whole wavefront instead."""
    jscene, scene, cfg, lanes = _case(name)
    key = make_key(7)
    if lanes is not None:
        pk, kinds = _window_bounces(scene, cfg, lanes, key)
    else:
        jcfg = JaxConfig(**dataclasses.asdict(cfg))
        o, d = _rays(scene, cfg)
        pk, active = integrator._first_path(cfg, o, d)
        kinds = set()
        for depth in range(cfg.max_bounces + 1):
            if not bool(active.any()):
                break
            rec = integrator.find_nearest_world(scene, pk[0:3].T, pk[3:6].T, active)
            kinds |= set(rec["mat"][active].tolist())
            with jax.disable_jit():
                want = jax_integrator._bounce_core(jscene, jcfg, _jax_state(pk),
                                                   jax.random.fold_in(jax.random.PRNGKey(7),
                                                                      depth))
            active = integrator._bounce_core(scene, cfg, pk, active, fold_in(key, depth))
            assert torch.equal(active, pk[bounce.R_ACT] > 0.5)
            _hold_state(pk, want, f"{name} bounce {depth}")
    assert len(kinds) >= 3, kinds
    if name.startswith(("media", "det")):
        assert kinds & {8} and kinds & set(range(9, 15)), kinds  # glass and smoke hits
    if name.endswith("kill"):
        assert bool((pk[bounce.R_LK] > 0.5).any())


@pytest.mark.parametrize("loop", ["plain", "reorder", "compact", "reorder_chunks"])
def test_frames_match_jax(loop):
    """Whole media frames with the deterministic lights and the light kill
    (the smoke volume first) on each bounce loop, the radiance and the
    flags against the JAX ``trace_path``: the flags come back through the
    compaction's and the reorder's undo."""
    jscene, cfg = _media_kill(32, 32)
    cfg = dataclasses.replace(cfg, deterministic_lights=True)
    if loop == "reorder":
        cfg = dataclasses.replace(cfg, bounce_reorder="always", compact_min=1)
    elif loop == "compact":
        cfg = dataclasses.replace(cfg, compact_chunks=2, compact_min=1)
    elif loop == "reorder_chunks":
        cfg = dataclasses.replace(cfg, bounce_reorder="always", compact_min=1,
                                  reorder_compact_chunks=2)
    jscene, scene = _both(jscene)
    assert integrator.path_loop(scene, cfg, 1024) == loop.split("_")[0]
    o, d = _rays(scene, cfg)
    rad, aux = integrator.trace_path(scene, cfg, o, d, make_key(3), return_aux=True)
    with jax.disable_jit():
        jrad, jaux = jax_integrator.trace_path(
            jscene, JaxConfig(**dataclasses.asdict(cfg)), jnp.asarray(o.numpy()),
            jnp.asarray(d.numpy()), jax.random.PRNGKey(3), return_aux=True)
    _hold_path(rad.numpy(), jrad)
    flags = aux["in_light"].numpy()
    assert (flags == np.asarray(jaux["in_light"])).mean() >= 0.99
    assert flags.any() and 0.01 < float(rad.mean()) < 10.0


def test_cpu_frame_launches_no_bounce_kernel():
    """A CPU frame takes the plain stages and leaves every counter at 0."""
    scene, cfg = media_path(32, 32, bounces=3)
    before = dict(bounce.launches)
    img = integrator.render_tiled(scene, cfg, make_key(1), 1, 1)
    assert bounce.launches == before
    assert 0.01 < float(img.mean()) < 10.0


def test_bounce_wrappers_refuse_cpu_tensors():
    _, scene, cfg, _ = _case("monu")
    o, d = _rays(scene, cfg)
    pk, active = integrator._first_path(cfg, o, d)
    rec = integrator.find_nearest_world(scene, o, d, active)
    n = o.shape[0]
    u = torch.zeros(n)
    draws = bounce.Draws(u, torch.zeros(3, n), torch.zeros(3, n), u, torch.zeros(2, n),
                         torch.zeros(3, n), u, None, None, None, None, None)
    b = bounce.Bounce(pk, rec, integrator._material_rows(scene, rec["mat"]), draws,
                      scene.lights, cfg)
    for stage in bounce.KERNELS:
        with pytest.raises(ValueError, match="no bounce kernels for device cpu"):
            stage(b)
    assert bounce.launches == dict.fromkeys(bounce.launches, 0)


@pytest.mark.parametrize("name", ["monu", "lights", "media_kill", "det", "det_kill"])
def test_bounce_kernel_checks_take_the_staged_buffers(name, monkeypatch):
    """The kernels' argument checks and struct take every buffer the staged
    bounce hands them (the device aside: the CPU is refused there)."""
    monkeypatch.setattr(bounce, "_device", lambda b: -1)
    seen = []

    def hit(b):
        seen.append(bounce._check_bounce(b))
        assert bounce._cargs(b, -1).n == b.n
        bounce.hit_plain(b)

    _, scene, cfg, lanes = _case(name)
    o, d = _rays(scene, cfg)
    integrator._bounce_core(scene, cfg, *integrator._first_path(cfg, o, d), make_key(5),
                            lanes, stages=bounce.Stages(hit, bounce.nee_plain,
                                                        bounce.continue_plain))
    assert seen == [-1]


def test_bounce_struct_is_the_kernel_struct():
    """CArgs lists csrc/bounce.cu's Args fields in their order, and the
    struct a bounce fills holds each buffer under its own field."""
    src = CSRC.read_text()
    body = re.search(r"struct Args \{(.*?)\n\};", src, re.S).group(1)
    fields = re.findall(r"(\w+);", re.sub(r"//[^\n]*", "", body))
    assert fields == [f for f, _ in bounce.CArgs._fields_]

    _, scene, cfg, _ = _case("det_kill")
    o, d = _rays(scene, cfg)
    pk, active = integrator._first_path(cfg, o, d)
    rec = integrator.find_nearest_world(scene, o, d, active)
    n = o.shape[0]
    draws = bounce.Draws(*(torch.zeros(k, n).squeeze(0) for k in (1, 3, 3, 1, 2, 3)),
                         None, None, None, None, torch.zeros(6, 3, n), torch.zeros(6, 3, n))
    b = bounce.Bounce(pk, rec, integrator._material_rows(scene, rec["mat"]), draws,
                      scene.lights, cfg)
    assert b.m == 2 + 2 * 3 + 1 + 1 and b.sh_o.shape == (b.m * n, 3)
    c = bounce._cargs(b, -1)
    want = dict(pk=pk, mrow=b.mrow, march=b.march, mode=b.mode, **rec, **draws._asdict(),
                **{k: getattr(b, k) for k in ("sh_o", "sh_d", "sh_t", "need", "nee_val", "lk_d",
                                              "lk_t", "lk_need", "lk_val", "go_diffuse",
                                              "nee_mask", "out_in_glass", "out_active",
                                              "out_in_light")},
                **{f: getattr(scene.lights, f) for f in bounce._LIGHTS})
    want["spot_cos"] = want.pop("spot_cos_angle")
    for name, x in want.items():
        if name in fields:
            assert getattr(c, name) == (None if x is None else x.data_ptr()), name
    assert (c.stride, c.n, c.has_lk, c.n_point, c.n_area, c.n_spot, c.det, c.samples) == (
        n, n, 1, 2, 2, 1, 1, 3)
    f32 = torch.tensor([1 / 3, 0.01]).tolist()  # the Python floats rounded to float32
    assert (c.inv_samples, c.kill_threshold) == tuple(f32)
    assert not any(getattr(c, f) for f in ("in_vol", "t_exit", "ex_nx", "ex_ny", "ex_nz",
                                           "occ", "lk_occ", "u_nee", "g_nee", "u_lk", "g_lk"))


def test_bounce_kernel_names_are_in_no_roofline_family():
    from vtbench import trace

    names = re.findall(r"__global__ void __launch_bounds__\(\w+\) (\w+)\(", CSRC.read_text())
    assert names == ["bounce_hit_kernel", "bounce_nee_kernel", "bounce_continue_kernel"]
    for name in names:
        for shown in (name, f"(anonymous namespace)::{name}((anonymous namespace)::Args)",
                      f"_ZN12_GLOBAL__N_1{len(name)}{name}ENS_4ArgsE"):
            assert trace.family(shown) is None, shown
    assert set(bounce.launches) == {"bounce_hit", "bounce_nee", "bounce_continue"}
