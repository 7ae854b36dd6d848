"""The control, the reference computed in bfloat16 in the program's place,
comes out ``correct`` false through the harness's own window, keeper and
comparison on every cell, at a size a test run holds; the port, run the
same way, comes out true."""

import json

import pytest
import torch

from benchmark import check, control, spec

from conftest import TINY

CELLS = [w["name"] for w in spec.load_spec()["workloads"]]


def _lines(capsys):
    out = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    return [(role["role"], line) for role, line in zip(out[::2], out[1::2])]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(capsys, cell):
    rc = control.main(["--workload", cell, "--program-seeds", "11", "--control-seeds",
                       str(2**31 + 5), "--seconds", "0.1", "--device", "cpu",
                       "--traffic", json.dumps(TINY)])
    assert rc == 0
    (role_p, program), (role_c, low) = _lines(capsys)
    assert (role_p, role_c) == ("program", "control")
    assert program["correct"] is True
    assert low["correct"] is False and low["failed"] >= 1
    assert low["attempted"] >= TINY["check_requests"]
    limits = spec.resolve(spec.load_spec(), cell).traffic["limits"]
    assert any(low["compared"][k]["value"] > limits[k] for k in limits)


def test_low_precision_copy_computes_in_bfloat16():
    from benchmark.reference import dtypes

    low = control.low_precision_package()
    assert dtypes.real is torch.float32
    assert __import__(f"{low}.dtypes", fromlist=["real"]).real is torch.bfloat16
    cell = spec.resolve(spec.load_spec(), "cornell_box.north_star")
    scene = check.reference_scene(cell.config_path, "cpu", package=low)
    assert scene.compiled is not check.reference_scene(cell.config_path, "cpu").compiled
