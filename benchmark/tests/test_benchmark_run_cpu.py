"""The harness's CPU mode on tiny cells, through the port's plain versions:
the last line of standard output has exactly the contract's keys, no
device number, and the compared numbers last; and the exits that print no
result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, TINY

RUN = os.path.join(ROOT, "benchmark", "run.py")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(args, cwd=ROOT, timeout=300):
    return subprocess.run([sys.executable, RUN, *args], cwd=cwd, capture_output=True,
                          text=True, timeout=timeout)


def _check_line(line, trace):
    extra = ["breakdown"] if trace else []
    assert list(line) == KEYS + extra + ["compared"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert line["metrics"] == {}
    assert line["device"]["platform"] == "cpu" and line["device"]["memory_peak_bytes"] is None
    assert list(line["compared"]) == ["img_mean_rel", "img_max_rel"]


@pytest.mark.parametrize("cell,trace", [
    ("cornell_box.north_star", 0), ("balls.canonical", 1), ("cornell_box.ref_10k50", 0),
])
def test_cpu_mode_prints_the_contract_line(cell, trace):
    p = _run(["--workload", cell, "--seed", str(2**31 + 12345), "--seconds", "0.2",
              "--trace", str(trace), "--device", "cpu", "--traffic", json.dumps(TINY)])
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    _check_line(line, trace)
    names = list(line["compared"])
    tail = p.stderr.strip().splitlines()[-len(names):]
    assert [t.split()[1] for t in tail] == names
    assert all(t.startswith("compared ") and " limit " in t for t in tail)


def test_without_a_card_no_result():
    p = _run(["--workload", "cornell_box.north_star", "--seed", "1", "--seconds", "1"])
    if p.returncode == 0:
        pytest.skip("a CUDA card is present")
    assert p.returncode == 3 and p.stdout == ""


def test_unknown_cell_no_result():
    p = _run(["--workload", "nope.nope", "--seed", "1", "--seconds", "1", "--device", "cpu"])
    assert p.returncode == 2 and p.stdout == ""


def test_only_the_benchmark_files_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "cornell_box.north_star", "--seed", "1", "--seconds", "1",
                        "--device", "cpu", "--traffic", json.dumps(TINY)],
                       cwd=tmp_path, capture_output=True, text=True, timeout=120, env=env)
    assert p.returncode != 0 and p.stdout == ""
