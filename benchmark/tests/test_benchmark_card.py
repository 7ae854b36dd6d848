"""On the card (skipped without one): a short run of each cell at a small
size reports its end-to-end metrics, a device line and ``correct`` true;
run with ``python3 -m pytest benchmark/tests -m card``."""

import json
import subprocess
import sys

import pytest

from benchmark import spec

from conftest import ROOT

SMALL = {"width": 64, "height": 64, "warmup": 2, "trace_seconds": 0.5, "check_block": 4}


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in spec.load_spec()["workloads"]])
def test_short_run_on_the_card(card, cell):
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                        str(2**31 + 7), "--seconds", "1", "--traffic", json.dumps(SMALL)],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["compared"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    c = spec.resolve(spec.load_spec(), cell)
    assert set(line["metrics"]) == {m["name"] for m in c.end_to_end}
