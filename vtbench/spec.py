"""Everything a cell needs, found by name: the cell's entry in
BENCHMARK.json, its configuration (``configs/<config>.json``), its traffic
mix (``traffic/<traffic>.json``), the loop that mix names
(``loops/<kind>.py``), the reader of each metric it reports
(``metrics/<metric>.py``) and its correctness limits
(``limits/<cell>.json``).  An unknown name is refused."""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re
from dataclasses import dataclass

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_-]{0,63}$")


class SpecError(ValueError):
    """A name that BENCHMARK.json or the benchmark's files do not hold."""


@dataclass
class Cell:
    name: str
    entry: dict          # the workload's entry in BENCHMARK.json
    config: dict         # configs/<config>.json
    traffic: dict        # traffic/<traffic>.json
    end_to_end: list     # the end-to-end metric entries this cell reports
    per_layer: list      # the per-layer metric entries this cell reports
    limits: dict         # limits/<cell>.json: {number: {"limit": x, ...}}


def load_json(path: pathlib.Path) -> dict:
    if not path.is_file():
        raise SpecError(f"no file {path.relative_to(ROOT)}")
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether `cell` reports `metric`: its own ``workloads`` list, else
    (a per-layer metric) every cell that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_names if "moves" in metric else True


def cell(name: str, bench: dict | None = None, root: pathlib.Path = ROOT) -> Cell:
    bench = bench if bench is not None else benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SpecError(f"unknown workload {name!r}; BENCHMARK.json has {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if entry["config"] not in configs:
        raise SpecError(f"workload {name!r}: unknown config {entry['config']!r}")
    config = load_json(root / configs[entry["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    loop_path(traffic.get("loop"))
    e2e = [m for m in bench["end_to_end"] if reports(m, name, set())]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if reports(m, name, e2e_names)]
    for m in e2e + layer:
        reader_path(m["name"])
    limits = load_json(HERE / "limits" / f"{name}.json")
    return Cell(name=name, entry=entry, config=config, traffic=traffic, end_to_end=e2e,
                per_layer=layer, limits=limits)


def loop_path(kind) -> pathlib.Path:
    """The module of a loop kind, ``loops/<kind>.py``."""
    path = HERE / "loops" / f"{kind}.py"
    if not (isinstance(kind, str) and NAME.match(kind) and kind != "__init__"
            and path.is_file()):
        raise SpecError(f"traffic loop {kind!r} has no module loops/<kind>.py")
    return path


def reader_path(metric: str) -> pathlib.Path:
    path = HERE / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise SpecError(f"metric {metric!r} has no reader metrics/{metric}.py")
    return path


def reader(metric: str):
    """The ``read(record)`` function of metrics/<metric>.py."""
    path = reader_path(metric)
    spec = importlib.util.spec_from_file_location(f"vtbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
