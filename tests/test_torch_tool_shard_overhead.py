"""The port's ``tools/shard_overhead.py`` against the JAX package's, on the
CPU at cornell 8x8, 4 spp, depth 4, one rep: the port on
``make_mesh(1, device="cpu")`` (the tool's own mesh), JAX on ``make_mesh(1)``.
Both exit 0 and print one JSON line with the same keys in the same order,
the same config string and both agreement flags true; a sharded render
that leaves the direct one makes the port's tool exit 1, as JAX's does;
without a card the default device exits 1."""

import json
import sys

import pytest
import torch

from tools import shard_overhead as jtool
from zig_weekend_raytracer_tpu_torch import parallel
from zig_weekend_raytracer_tpu_torch.tools import shard_overhead as ttool

ARGS = ["8", "8", "4", "4", "1"]


def test_line_matches_jax(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["shard_overhead.py", *ARGS])
    jtool.main()
    jax_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ttool.main([*ARGS, "--device=cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert list(got) == list(jax_line)
    assert got["config"] == jax_line["config"] == "cornell_box 8x8@4spp d4 (1-dev mesh)"
    assert got["agree_samples"] and got["agree_rows"]
    assert jax_line["agree_samples"] and jax_line["agree_rows"]
    for k in ("direct_s", "sharded_samples_s", "sharded_rows_s"):
        assert got[k] > 0


def test_disagreement_exits_1(monkeypatch, capsys):
    real = parallel.render_sharded

    def off(*args, **kw):
        fb = real(*args, **kw)
        return fb + (1e-3 if kw["shard"] == "rows" else 0.0)

    monkeypatch.setattr(parallel, "render_sharded", off)
    assert ttool.main([*ARGS, "--device=cpu"]) == 1
    got = json.loads(capsys.readouterr().out)
    assert got["agree_samples"] and not got["agree_rows"]


def test_device_and_flags(capsys):
    if not torch.cuda.is_available():
        assert ttool.main(ARGS) == 1
        assert "CUDA is not available" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="unknown flags"):
        ttool.main([*ARGS, "--reps=2"])
    with pytest.raises(SystemExit, match="expected 'cuda' or 'cpu'"):
        ttool.main([*ARGS, "--device=tpu"])
