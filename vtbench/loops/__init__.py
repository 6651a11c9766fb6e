"""The benchmark's traffic generator.  A traffic mix is data:
``traffic/<mix>.json`` names a kind of closed loop in ``"loop"`` and gives
its parameters, and the loop of that kind is the module
``loops/<kind>.py`` (its class ``LOOP``), found by name.  A new mix of a
kind that is here is a data file alone; a new kind is a new module here.
No file that is here needs an edit for either.

A loop is set up on one side (the program, or the reference in its place
for a control), warms its shapes, runs one iteration at a time for the
window, keeps what the check compares, frees its state, and works the
same outputs out again on the reference side.  It passes the parameter
groups of its traffic file straight to the entry it calls: ``render``
to the configuration's ``RenderConfig``, ``call`` to the entry itself,
and what else its module names.

Every iteration does the same work whatever the seed: the seed picks the
keys (and the target), never the sizes.
"""

from __future__ import annotations

import importlib
import random
from dataclasses import dataclass, field

from vtbench import spec


def seed_key(side, seed: int):
    return side.mod("core.rng").make_key(seed % (1 << 64))


def call_args(group: dict | None) -> dict:
    """A parameter group of a traffic file as keyword arguments (a JSON
    list becomes a tuple)."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in (group or {}).items()}


@dataclass
class Check:
    """One output the check compares: what the reference needs to make it
    again (`inputs`) and what the program made (`outputs`)."""
    label: str
    inputs: dict
    outputs: dict = field(default_factory=dict)


class Loop:
    """What the harness drives.  A kind defines ``work``, ``setup``,
    ``step``, ``replay``, ``reference`` and ``numbers``, and may define
    ``spans(out, device)``, which hooks the traced run's spans and
    returns a function that removes the hooks."""

    # the program's modules whose ``launches`` counters the drive check reads
    launch_modules = ("kernels.traverse", "kernels.lookup")
    # the counters the window has to move
    counters = ("traverse_nearest", "traverse_occluded", "lookup_rows")
    first = 0  # the first iteration of the window (set-up runs those before)

    def __init__(self, traffic: dict, seed: int, media: bool = False):
        self.t = traffic
        self.seed = seed
        self.media = media
        self.checks: list[Check] = []
        # the window iteration kept for the check besides the last one
        self.sample = random.Random(seed).randrange(traffic.get("sample_of_first", 8))

    def expected_launches(self) -> tuple:
        return self.counters + (("exit_march",) if self.media else ())

    def make_inputs(self, cfg, device) -> dict:
        """Inputs the benchmark makes from the seed for both sides."""
        return {}

    def work(self, cfg) -> int:
        """Primary rays an iteration."""
        raise NotImplementedError

    def units(self) -> str:
        return "frames"

    def setup(self, side, scene, cfg, inputs):
        """Set up on `side` and warm every shape; sets ``first``."""
        raise NotImplementedError

    def step(self, i):
        """Window iteration i -> its outputs."""
        raise NotImplementedError

    def replay(self, i):
        """Traced iteration i once more (its kernels' work is counted)."""
        raise NotImplementedError

    def reference(self, side, scene, cfg, inputs, check) -> dict:
        """`check`'s outputs made again on the reference `side`."""
        raise NotImplementedError

    def numbers(self, prog, ref) -> dict:
        """The numbers compared: name -> reading (limits/<cell>.json)."""
        raise NotImplementedError

    def keep_for_replay(self, i):
        """Iteration i is traced: keep what ``replay(i)`` needs."""

    def observe(self, i, out):
        """Iteration i of the window made `out`."""

    def close(self):
        """The window has closed."""

    def release(self):
        """Free the program's state; `checks` stays."""
        self.side = self.scene = None


def make(traffic: dict, seed: int, media: bool = False) -> Loop:
    """The loop that ``traffic["loop"]`` names (``loops/<kind>.py``)."""
    kind = traffic.get("loop")
    spec.loop_path(kind)
    return importlib.import_module(f"vtbench.loops.{kind}").LOOP(traffic, seed, media)


def render_overrides(traffic: dict) -> dict:
    """The RenderConfig fields a traffic mix sets."""
    return dict(traffic.get("render", {}))
