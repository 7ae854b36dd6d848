"""The Book 2 final scene's configuration: its images are the repository's
own, byte for byte, so the configuration depends on nothing outside the
benchmark's directory; and the harness's CPU mode runs its cell, traced,
at a tiny size through the port's plain versions."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import spec

from conftest import ROOT, TINY

CONFIG_DIR = os.path.dirname(spec.resolve(spec.load_spec(), "rtw_final.book2").config_path)


@pytest.mark.parametrize("name", ["wap.jpg", "me.jpg"])
def test_images_are_the_repositorys_byte_for_byte(name):
    with open(os.path.join(CONFIG_DIR, name), "rb") as a, \
            open(os.path.join(ROOT, "assets", name), "rb") as b:
        assert a.read() == b.read()


def test_scene_file_names_only_images_beside_it():
    with open(os.path.join(CONFIG_DIR, "rtw_final.json")) as f:
        textures = json.load(f)["textures"]
    images = sorted(t["image"] for t in textures.values() if "image" in t)
    assert images == ["me.jpg", "wap.jpg"]
    assert all(os.path.isfile(os.path.join(CONFIG_DIR, i)) for i in images)


def test_cpu_mode_runs_the_cell_traced():
    p = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
                        "--workload", "rtw_final.book2", "--seed", str(2**31 + 77),
                        "--seconds", "0.2", "--trace", "1", "--device", "cpu",
                        "--traffic", json.dumps(TINY)],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0 and line["metrics"] == {}
    assert list(line["compared"]) == ["img_mean_rel", "img_max_rel"]
