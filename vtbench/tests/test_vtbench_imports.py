"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program (checked in fresh interpreters)."""

import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
VT = ROOT / "vtbench"


def loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
                          "sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def module_names(pkg: pathlib.Path, prefix: str) -> list:
    return [prefix + "." + ".".join(p.relative_to(pkg).with_suffix("").parts)
            for p in sorted(pkg.rglob("*.py")) if p.name != "__init__.py"]


def test_harness_loads_no_jax():
    metrics = [p.stem for p in (VT / "metrics").glob("*.py")]
    code = ("import runpy, vtbench.run, vtbench.harness, vtbench.loops, vtbench.tools.readings\n"
            + "".join(f"import {m}\n" for m in module_names(VT / "reference", "vtbench.reference"))
            + "".join(f"import {m}\n" for m in module_names(VT / "loops", "vtbench.loops"))
            + "from vtbench import spec, sides\n"
            + "".join(f"spec.reader({m!r})\n" for m in metrics)
            + "for r in (sides.PROGRAM, sides.REFERENCE):\n"
            + "    [sides.Side(r).mod(m) for m in ('render.integrator', 'render.reproject',"
            + " 'diff.train', 'diff.volumetric')]\n")
    loaded = loaded_after(code)
    assert not loaded & {"jax", "jaxlib", "flax", "voxtracer"}
    assert "voxtracer_torch" in loaded


def test_reference_loads_nothing_of_the_program():
    code = "".join(f"import {m}\n" for m in module_names(VT / "reference", "vtbench.reference"))
    loaded = loaded_after(code)
    assert not loaded & {"voxtracer_torch", "voxtracer", "jax"}


def test_reference_sources_import_nothing_of_the_program():
    for path in (VT / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("voxtracer_torch", "voxtracer", "jax"), (path, n)
