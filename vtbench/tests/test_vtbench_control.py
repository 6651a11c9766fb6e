"""The comparison that decides ``correct`` fails what it must, on tiny
frames on the CPU: the control (the reference in the program's place,
computed in bfloat16), and a run of the harness (its look for a card
skipped) with the program broken underneath: an answer altered where it
is produced, a training step that leaves its state unchanged, half of
the batch left out with the mean taken over the rest.  The same run
unbroken comes out correct."""

import dataclasses
import json
import random
import time

import pytest
import torch

from vtbench import compare, harness, loops, sides, spec

TINY = {"width": 128, "height": 16}


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(name, seed=2147483911):
    return harness.run_cell(spec.cell(name), seed, 0.2, False, "cpu", time.time(),
                            render=TINY, drive_check=False)


@pytest.mark.parametrize("name", ["monu.frame", "monu.reproject", "monu.train_step"])
def test_control_fails(name):
    cell = spec.cell(name)
    inputs = sides.make_inputs(cell.config)
    ref = sides.Side(sides.REFERENCE)
    ov = {**loops.render_overrides(cell.traffic), **TINY}
    loop = loops.make(cell.traffic, 2147483913)
    scene, cfg = sides.make_scene(ref, cell.config, inputs, "cpu", **ov)
    li = loop.make_inputs(cfg, torch.device("cpu"))
    with compare.Bf16():
        loop.setup(ref, scene, cfg, li)
        out = loop.step(loop.first)
        loop.observe(loop.first, out)
        loop.close()
    nums = harness.reference_numbers(cell, loop, loop.checks, inputs, li, ov,
                                     torch.device("cpu"))
    assert not all(ok for *_, ok in compare.judge(nums, cell.limits)), nums


@pytest.mark.parametrize("name", ["monu.frame", "monu.reproject", "monu.train_step"])
def test_unbroken_run_is_correct(name):
    res = run(name)
    assert res["correct"], res["limits"]


def test_frame_altered_where_produced(monkeypatch):
    from voxtracer_torch.render import integrator

    orig = integrator.render_tiled
    monkeypatch.setattr(integrator, "render_tiled", lambda *a, **k: orig(*a, **k) + 0.01)
    assert not run("monu.frame")["correct"]


def test_reproject_altered_where_produced(monkeypatch):
    from voxtracer_torch.render import reproject

    orig = reproject.render_reproject_frame

    def altered(*a, **k):
        img, hist, g = orig(*a, **k)
        return img + 0.01, hist, g

    monkeypatch.setattr(reproject, "render_reproject_frame", altered)
    assert not run("monu.reproject")["correct"]


def test_step_leaves_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    res = run("monu.train_step")
    assert not res["correct"] and res["limits"]["change_norm_gap"]["value"] == 1.0


def test_half_the_batch_left_out(monkeypatch):
    from voxtracer_torch.diff import train

    orig = train.binned_grads

    def halved(params, scene, plan):
        bins = [dataclasses.replace(b, n_active=max(1, b.n_active // 2)) for b in plan.bins]
        return orig(params, scene, dataclasses.replace(plan, bins=bins, denom=plan.denom / 2))

    monkeypatch.setattr(train, "binned_grads", halved)
    assert not run("monu.train_step")["correct"]


def test_density_gradient_off_by_a_third(monkeypatch):
    """The density logits' gradient is small beside the albedos' (on the
    median's scale a 30% fault reads ~1e-4); held on its own scale, it
    fails."""
    from voxtracer_torch.diff import train

    orig = train.binned_grads

    def scaled(params, scene, plan):
        loss, g = orig(params, scene, plan)
        return loss, dataclasses.replace(g, density_logits=g.density_logits * 0.7)

    monkeypatch.setattr(train, "binned_grads", scaled)
    res = run("monu.train_step")
    assert not res["correct"] and res["limits"]["grad_leaf_gap"]["value"] > 0.2


def test_history_drift_over_the_window(monkeypatch):
    """A history that drifts a little every frame, under the limit on any
    one frame: the reference's chain from zeros sees what it builds up."""
    from voxtracer_torch.render import reproject

    orig = reproject.render_reproject_frame

    def drifting(*a, **k):
        img, hist, g = orig(*a, **k)
        return img, hist + 6e-4, g

    monkeypatch.setattr(reproject, "render_reproject_frame", drifting)
    seed = 2147483903  # draws the window's first frame for the chain
    assert random.Random(seed).randrange(8) == 0
    res = run("monu.reproject", seed=seed)
    assert not res["correct"], res["limits"]


def test_a_mix_of_data_alone_reaches_both_sides(monkeypatch):
    """A traffic mix that differs from one here in its data alone (the
    importance probes) runs and is correct: each parameter of its file
    reaches the entry, on the program and on the reference."""
    cell = spec.cell("monu.train_step")
    traffic = json.loads(json.dumps(cell.traffic))
    traffic["bins"]["importance"] = 8
    seen = set()
    for root in (sides.PROGRAM, sides.REFERENCE):
        mod = sides.Side(root).mod("diff.train")

        def spy(*a, _orig=mod.prepare_bins, _root=root, **k):
            seen.add((_root, k.get("importance")))
            return _orig(*a, **k)

        monkeypatch.setattr(mod, "prepare_bins", spy)
    res = harness.run_cell(dataclasses.replace(cell, traffic=traffic), 2147483931, 0.2,
                           False, "cpu", time.time(), render=TINY, drive_check=False)
    assert res["correct"], res["limits"]
    assert seen == {(sides.PROGRAM, 8), (sides.REFERENCE, 8)}
