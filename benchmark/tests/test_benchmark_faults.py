"""A run with the timed path broken underneath reports ``correct`` false:
each fault a cell can have, planted in the port's entry that the harness
calls, on the CPU at a tiny size (the harness's look for a card is
skipped by ``--device cpu``).  One card has no exchange between chips to
leave out.  Every cell gets every fault, and the harness is also shown to
send each request its own seed."""

import dataclasses
import json
import time

import pytest
import torch

from benchmark import check, harness, spec

from conftest import TINY

CELLS = [w["name"] for w in spec.load_spec()["workloads"]]


def _run(capsys, cell):
    argv = ["--workload", cell, "--seed", str(2**31 + 99), "--seconds", "0.1",
            "--device", "cpu", "--traffic", json.dumps(TINY)]
    assert harness.main(argv, time.perf_counter()) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _patch_render(monkeypatch, fn):
    from zig_weekend_raytracer_tpu_torch.render.renderer import Renderer

    original = Renderer.render_device
    monkeypatch.setattr(Renderer, "render_device",
                        lambda self, scene, w, h: fn(original, self, scene, w, h))


def state_unchanged(original, self, scene, w, h):
    """The framebuffer comes back as it started: zeros."""
    return torch.zeros((h, w, 3))


def half_the_samples(original, self, scene, w, h):
    """Half of each pixel's samples left out, the mean taken over the rest."""
    half = dataclasses.replace(self, samples_per_pixel=self.samples_per_pixel // 2)
    return original(half, scene, w, h)


def seed_ignored(original, self, scene, w, h):
    """Every request gets the image of one seed, as a framebuffer memoised
    by scene and size would give it."""
    return original(dataclasses.replace(self, seed=0), scene, w, h)


def answer_altered(original, self, scene, w, h):
    """Two rows of the image altered where they are produced."""
    img = original(self, scene, w, h).clone()
    img[:2] += 0.25
    return img


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [state_unchanged, half_the_samples, seed_ignored,
                                   answer_altered])
def test_render_fault_is_caught(capsys, monkeypatch, cell, fault):
    assert _run(capsys, cell)["correct"] is True
    _patch_render(monkeypatch, fault)
    line = _run(capsys, cell)
    assert line["correct"] is False and line["failed"] >= 1


def test_each_request_renders_its_own_seed(capsys, monkeypatch):
    seeds = []

    def record(original, self, scene, w, h):
        seeds.append(self.seed)
        return original(self, scene, w, h)

    _patch_render(monkeypatch, record)
    line = _run(capsys, "cornell_box.north_star")
    run_seed = 2**31 + 99
    assert seeds == [check.request_seed(run_seed, i) for i in range(len(seeds))]
    assert len(set(seeds)) == len(seeds) == TINY["warmup"] + line["attempted"]
