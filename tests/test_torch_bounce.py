"""The staged path bounce (``integrator._bounce_core_staged``) against the
plain bounce (``_bounce_core_plain``) on the CPU.

On the card the bounce's shading runs as the three kernels of
csrc/bounce.cu; here their plain versions (``kernels.bounce.PLAIN``) run
in the same order, between the same traversals, and must give the plain
bounce's state bit for bit: one bounce at a time over every material
class, the exit march, each light type, the light kill, threefry draws
and a window of lanes, and whole frames on the plain, reordered and
compacted loops.  A CPU frame launches no kernel; the kernels' wrapper
refuses CPU tensors, its argument struct is the kernel's field for field,
and no kernel name falls into a family of the benchmark's roofline."""

import dataclasses
import pathlib
import re

import pytest
import torch

from voxtracer_torch.core.rng import fold_in, make_key
from voxtracer_torch.kernels import bounce
from voxtracer_torch.render import integrator
from voxtracer_torch.scene.instances import build_volumes
from voxtracer_torch.scene.lights import make_lights
from voxtracer_torch.scene.presets import media_path, media_specs, monu_like_path

torch.set_num_threads(1)

CSRC = pathlib.Path(integrator.__file__).resolve().parent.parent / "csrc" / "bounce.cu"


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same_state(a, b, what):
    keys = ("o", "d", "tp", "rad", "sky_tp", "sky_d", "in_glass", "active", "in_light")
    assert set(k for k in keys if k in a) == set(k for k in keys if k in b), what
    for k in keys:
        if k not in a:
            continue
        xs = a[k] if isinstance(a[k], tuple) else (a[k],)
        ys = b[k] if isinstance(b[k], tuple) else (b[k],)
        for c, (x, y) in enumerate(zip(xs, ys)):
            assert torch.equal(_bits(x), _bits(y)), f"{what}: {k}[{c}] differs"


def _start(o, d, cfg):
    """trace_path's first state."""
    n = o.shape[0]
    zero3 = tuple(torch.zeros(n) for _ in range(3))
    st = dict(o=integrator.cpack(o), d=integrator.cpack(d),
              tp=tuple(torch.ones(n) for _ in range(3)), rad=zero3,
              in_glass=torch.zeros(n, dtype=torch.bool), active=torch.ones(n, dtype=torch.bool),
              sky_tp=zero3, sky_d=integrator.cpack(d))
    if cfg.detect_light_kill:
        st["in_light"] = torch.zeros(n, dtype=torch.bool)
    return st


def _rays(scene, cfg):
    py, px = torch.meshgrid(torch.arange(cfg.height, dtype=torch.float32) + 0.5,
                            torch.arange(cfg.width, dtype=torch.float32) + 0.5, indexing="ij")
    return integrator.primary_rays(scene.camera, cfg.width, cfg.height, px.reshape(-1),
                                   py.reshape(-1))


def _all_lights(scene):
    """Every light type, the directional one lit."""
    return dataclasses.replace(scene, lights=make_lights(
        point=((0.0, 3.0, -2.0, 6.0, 6.0, 6.0), (1.0, 2.0, 1.0, 2.0, 1.0, 0.5)),
        spot=((-1.0, 2.5, -1.0, 0.3, -0.9, 0.3, 4.0, 4.0, 3.0, 0.6),),
        area=((0.5, 2.0, -1.5, 3.0, 3.0, 3.0, 2.0, 0.4), (-0.5, 1.5, 0.5, 1.0, 2.0, 1.0, 1.0, 0.2)),
        directional=((0.3, -1.0, 0.2), (0.8, 0.7, 0.6))))


def _case(name):
    if name in ("det", "det_kill"):
        scene, cfg = _case("media_kill" if name == "det_kill" else "media")[:2]
        return _all_lights(scene), dataclasses.replace(cfg, deterministic_lights=True), None
    if name in ("media", "media_kill"):
        scene, cfg = media_path(32, 32, bounces=4)
        if name == "media_kill":
            # the smoke volume first: the light kill looks at volume 0
            specs = media_specs()
            scene = dataclasses.replace(scene, volumes=build_volumes(specs[-1:] + specs[:-1]))
            cfg = dataclasses.replace(cfg, detect_light_kill=True, light_kill_threshold=0.01)
        return scene, cfg, None
    scene, cfg = monu_like_path(32, 16, gridsize=16, bounces=4)
    lanes = None
    if name == "lights":
        scene = _all_lights(scene)
    elif name == "threefry":
        cfg = dataclasses.replace(cfg, rng="threefry")
    elif name == "lanes":
        lanes = (96, 2048)
    return scene, cfg, lanes


@pytest.mark.parametrize("name", ["monu", "media", "media_kill", "lights", "threefry", "lanes",
                                  "det", "det_kill"])
def test_staged_plain_bounce_is_the_plain_bounce(name):
    """Each bounce of a frame: the plain stages between the traversals give
    the plain bounce's state bit for bit."""
    scene, cfg, lanes = _case(name)
    o, d = _rays(scene, cfg)
    st = _start(o, d, cfg)
    key = make_key(7)
    kinds = set()
    for depth in range(cfg.max_bounces + 1):
        if not bool(st["active"].any()):
            break
        bkey = fold_in(key, depth)
        rec = integrator.find_nearest_world(scene, st["o"], st["d"], st["active"])
        kinds |= set(rec["mat"][st["active"]].tolist())
        want = integrator._bounce_core_plain(scene, cfg, st, bkey, lanes)
        got = integrator._bounce_core_staged(scene, cfg, st, bkey, lanes, stages=bounce.PLAIN)
        _same_state(got, want, f"{name} bounce {depth}")
        st = want
    assert len(kinds) >= 3, kinds
    if name.startswith(("media", "det")):
        assert kinds & {8} and kinds & set(range(9, 15)), kinds  # glass and smoke hits
    if name.endswith("kill"):
        assert bool(st["in_light"].any())


@pytest.mark.parametrize("loop", ["plain", "reorder", "compact", "reorder_chunks"])
def test_staged_plain_frames_are_the_plain_frames(loop, monkeypatch):
    """Whole frames with the staged bounce swapped in, in place on the packed
    state (the reordered and compacted loops shade chunk views of it),
    against the plain bounce."""
    scene, cfg = monu_like_path(32, 16, gridsize=16, bounces=4)
    if loop == "reorder":
        cfg = dataclasses.replace(cfg, bounce_reorder="always", compact_min=1)
    elif loop == "compact":
        cfg = dataclasses.replace(cfg, compact_chunks=4, compact_min=1)
    elif loop == "reorder_chunks":
        cfg = dataclasses.replace(cfg, bounce_reorder="always", compact_min=1,
                                  reorder_compact_chunks=4)
    assert integrator.path_loop(scene, cfg, 512) == loop.split("_")[0]
    o, d = _rays(scene, cfg)
    key = make_key(3)
    want = integrator.trace_path(scene, cfg, o, d, key)

    def staged(scene, cfg, st, bkey, lanes=None):
        return integrator._bounce_core_staged(scene, cfg, st, bkey, lanes, stages=bounce.PLAIN)

    monkeypatch.setattr(integrator, "_bounce_core", staged)
    got = integrator.trace_path(scene, cfg, o, d, key)
    assert torch.equal(_bits(got), _bits(want))
    assert 0.01 < float(want.mean()) < 10.0


def test_cpu_frame_launches_no_bounce_kernel(monkeypatch):
    """A CPU frame takes the plain bounce and leaves every counter at 0."""
    scene, cfg = media_path(32, 32, bounces=3)
    before = dict(bounce.launches)
    got = integrator.render_tiled(scene, cfg, make_key(1), 1, 1)
    assert bounce.launches == before
    monkeypatch.setattr(integrator, "_bounce_core", integrator._bounce_core_plain)
    want = integrator.render_tiled(scene, cfg, make_key(1), 1, 1)
    assert torch.equal(_bits(got), _bits(want))


def test_bounce_wrappers_refuse_cpu_tensors():
    scene, cfg, _ = _case("monu")
    o, d = _rays(scene, cfg)
    st = _start(o, d, cfg)
    pk = integrator._pack_path(st, torch.zeros(o.shape[0]))
    rec = integrator.find_nearest_world(scene, st["o"], st["d"], st["active"])
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

    scene, cfg, lanes = _case(name)
    o, d = _rays(scene, cfg)
    integrator._bounce_core_staged(scene, cfg, _start(o, d, cfg), make_key(5), lanes,
                                   stages=bounce.Stages(hit, bounce.nee_plain,
                                                        bounce.continue_plain))
    assert seen == [-1]


def test_bounce_struct_is_the_kernel_struct():
    """CArgs lists csrc/bounce.cu's Args fields in their order, and the
    struct a bounce fills holds each buffer under its own field."""
    src = CSRC.read_text()
    body = re.search(r"struct Args \{(.*?)\n\};", src, re.S).group(1)
    fields = re.findall(r"(\w+);", re.sub(r"//[^\n]*", "", body))
    assert fields == [f for f, _ in bounce.CArgs._fields_]

    scene, cfg, _ = _case("det_kill")
    o, d = _rays(scene, cfg)
    st = _start(o, d, cfg)
    pk = integrator._pack_path(st, torch.zeros(o.shape[0]))
    rec = integrator.find_nearest_world(scene, st["o"], st["d"], st["active"])
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
    assert set(bounce.launches) == {"bounce_hit", "bounce_nee", "bounce_continue",
                                    "bounce_plain"}
