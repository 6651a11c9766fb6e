"""run.py's refusals: without a card it exits non-zero and prints no
result; an unknown workload is refused."""

import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]


def run(*args, env=None):
    return subprocess.run([sys.executable, "vtbench/run.py", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = run("--workload", "monu.frame", "--seed", "2147483905", "--seconds", "1",
              "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_unknown_workload_refused():
    out = run("--workload", "no.such.cell", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
def test_one_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import json

    out = run("--workload", "monu.frame", "--seed", "2147483907", "--seconds", "2",
              "--trace", "0")
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "limits"
