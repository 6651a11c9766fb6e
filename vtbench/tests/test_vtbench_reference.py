"""The reference agrees with the program's plain path (its CPU route) at
64 x 64 on the CPU: path frames at 4 volumes and at 111 (the reorder and
pages), the reprojected frame, and the fused step's gradients."""

import pytest
import torch

from vtbench import compare, sides, spec


@pytest.fixture(scope="module", autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scenes(config, size=64, **render):
    conf = spec.load_json(spec.ROOT / f"vtbench/configs/{config}.json")
    inputs = sides.make_inputs(conf)
    prog, ref = sides.Side(sides.PROGRAM), sides.Side(sides.REFERENCE)
    return (prog, *sides.make_scene(prog, conf, inputs, "cpu", width=size, height=size, **render),
            ref, *sides.make_scene(ref, conf, inputs, "cpu", width=size, height=size, **render))


@pytest.mark.parametrize("config,size,extra", [("monu_like_1080p", 64, {}),
                                               ("city_xl_like_1080p", 32,
                                                {"compact_min": 256})])
def test_path_frame(config, size, extra):
    prog, ps, pc, ref, rs, rc = scenes(config, size, **extra)
    key = (12, 34)
    a = prog.mod("render.integrator").render_tiled(ps, pc, key, 1, 1)
    b = ref.mod("render.integrator").render_tiled(rs, rc, key, 1, 1)
    assert compare.pixels_off(a, b) == 0.0
    assert torch.allclose(a, b, atol=1e-5, rtol=1e-5)


def test_reproject_frame():
    prog, ps, pc, ref, rs, rc = scenes("monu_like_1080p", 64, mode="reproject")
    hist = torch.rand(64, 64, 3, generator=torch.Generator().manual_seed(3))
    a = prog.mod("render.reproject").render_reproject_frame(ps, pc, ps.camera, hist, (5, 6))
    b = ref.mod("render.reproject").render_reproject_frame(rs, rc, rs.camera, hist, (5, 6))
    for x, y in zip(a[:2], b[:2]):
        assert torch.allclose(x, y, atol=1e-5, rtol=1e-5)


def test_fused_step_gradients():
    prog, ps, pc, ref, rs, rc = scenes("monu_like_1080p", 64)
    target = torch.rand(64, 64, 3, generator=torch.Generator().manual_seed(4))
    out = []
    for side, s, c in ((prog, ps, pc), (ref, rs, rc)):
        plan = side.mod("diff.train").prepare_bins(s, c, target, bin_steps=(2, 10),
                                                   edges=(4.0,), tiles=2)
        params = side.mod("diff.volumetric").params_from_scene(s)
        out.append(side.mod("diff.train").fused_step(params, s, c, (7, 8), plan))
    (ma, ga), (mb, gb) = out
    assert float(ma) == pytest.approx(float(mb), rel=1e-6)
    for leaf in ("density_logits", "albedo_table"):
        a, b = getattr(ga, leaf), getattr(gb, leaf)
        assert float((a - b).norm()) <= 1e-5 * float(b.norm()) + 1e-12, leaf


def test_traversals_against_the_program_plain_walks():
    """The reference's pair walks against the program's dense plain walks,
    on rays through the glass and smoke of a media scene: nearest (with and
    without a t limit), occluded and the exit march."""
    from voxtracer_torch.kernels import traverse as pt
    from voxtracer_torch.scene.presets import media_specs
    from voxtracer_torch.scene.instances import build_volumes
    from vtbench.reference.kernels import traverse as rt

    gen = torch.Generator().manual_seed(5)
    n = 3000
    o = torch.rand(n, 3, generator=gen) * 2 - 1 + torch.tensor([0.0, 0.2, -1.5])
    d = torch.nn.functional.normalize(torch.rand(n, 3, generator=gen) - 0.5 +
                                      torch.tensor([0.0, 0.0, 0.6]), dim=1)
    act = torch.rand(n, generator=gen) < 0.9
    tl = torch.rand(n, generator=gen) * 4
    vols = build_volumes(media_specs())
    args = (vols.grids.reshape(-1), vols.gridsize, vols.inv, vols.fwd, vols.cube_min, o, d)
    for mode, lim in (("nearest", None), ("nearest", tl), ("occluded", tl)):
        a = pt.traverse_plain(*args, lim, act, None, vols.occ, vols.bricksize, mode=mode)
        b = rt.traverse(*args, lim, act, None, vols.occ, vols.bricksize, mode=mode)
        for k in a:
            assert torch.equal(a[k], b[k].to(a[k].dtype)), (mode, k)
    first = pt.traverse_plain(*args, None, act, None, vols.occ, vols.bricksize)
    code = torch.where(first["cell"] == 8, 0, 1).to(torch.int32)
    march = act & first["hit"] & (first["cell"] >= 8) & (first["cell"] <= 14)
    assert int(march.sum()) > 20
    p0 = o + d * (first["t"][:, None] + 1e-4)
    a = pt.exit_march_plain(vols.grids.reshape(-1), vols.gridsize, vols.inv, vols.fwd,
                            vols.cube_min, p0, d, march, code, first["vol"], vols.occ,
                            vols.bricksize)
    b = rt.exit_march(vols.grids.reshape(-1), vols.gridsize, vols.inv, vols.fwd,
                      vols.cube_min, p0, d, march, code, first["vol"], vols.occ, vols.bricksize)
    for k in a:
        assert torch.equal(a[k][march], b[k][march].to(a[k].dtype)), ("exit", k)
