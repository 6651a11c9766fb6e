"""The harness finds every configuration, traffic mix, metric reader and
limit file of BENCHMARK.json by name, and refuses an unknown name."""

import json
import re

import pytest

from vtbench import loops, spec

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves(name):
    c = spec.cell(name)
    assert isinstance(loops.make(c.traffic, 1), loops.Loop)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in names, f"{m['name']} moves {m['moves']}, which {name} does not report"
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))
    assert c.limits


def test_unknown_names_are_refused(tmp_path):
    with pytest.raises(spec.SpecError):
        spec.cell("no.such.cell")
    with pytest.raises(spec.SpecError):
        spec.reader("no_such_metric")
    bad = json.loads(json.dumps(BENCH))
    bad["workloads"][0]["config"] = "no_such_config"
    with pytest.raises(spec.SpecError):
        spec.cell(bad["workloads"][0]["name"], bad)
    bad = json.loads(json.dumps(BENCH))
    bad["workloads"][0]["traffic"] = "no_such_traffic"
    with pytest.raises(spec.SpecError):
        spec.cell(bad["workloads"][0]["name"], bad)
    for kind in ("no_such_loop", "__init__", "../spec", None):
        with pytest.raises(spec.SpecError):
            loops.make({"loop": kind}, 1)
    bad = json.loads(json.dumps(BENCH))
    bad["per_layer"].append({"name": "no.such.reader", "unit": "%", "better": "higher",
                             "source": "device_trace", "layer": "kernels",
                             "moves": "rays_per_s", "workloads": ["monu.frame"]})
    with pytest.raises(spec.SpecError):
        spec.cell("monu.frame", bad)


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["vtbench"] and 1 <= BENCH["run_seconds"] <= 51
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        conf = json.loads((spec.ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
