"""The port's FP32-peak microbenchmark (``tools/fp32_peak.py``, kernel K5)
on the CPU.

  1. The chain kernel's plain version against the JAX package's
     ``tools/vpu_peak.py`` chains, built with ``interpret=True``, for all
     four ops, within rtol 1e-5 (XLA on the CPU may contract the fma chain
     differently; the port's plain fma rounds once, as fmaf does).
  2. The closed forms the rate accounting assumes: the chains are genuine
     recurrences, not foldable no-ops.
  3. The wrapper: CPU multipliers run the plain version and launch nothing;
     another device raises.
  4. ``run``'s verdicts, reached directly with the card's measurements
     replaced: a rate past 105% of the physics bound, or a 4x / 1x time
     ratio outside [3, 5], makes the reading fail; the add rate is the one
     the roofline takes.  The rates themselves come only from the card
     (``chip_smoke.py`` phase 1b).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools import vpu_peak
from zig_weekend_raytracer_tpu_torch.tools import fp32_peak as fp

C = fp.C_VALUE


@pytest.mark.parametrize("op", fp.OPS)
@pytest.mark.parametrize("iters,chains,rows,unroll", [(40, 3, 8, 1), (10, 4, 8, 4)])
def test_chain_reference_matches_vpu_peak(op, iters, chains, rows, unroll):
    build = vpu_peak._kernels()
    want = np.asarray(jax.jit(build(op, iters, chains, rows, True, unroll))(
        jnp.full((1, vpu_peak.LANE), C, jnp.float32)))
    got = fp.chain_reference(op, fp.multipliers("cpu"), rows * 128, iters, chains, unroll)
    assert got.dtype == torch.float32 and got.shape == (rows * 128,)
    np.testing.assert_allclose(got.numpy().reshape(rows, 128), want, rtol=1e-5)


def test_chain_closed_forms():
    iters, chains, n = 40, 3, 256
    c = fp.multipliers("cpu")
    fma = fp.chain_reference("fma", c, n, iters, chains).numpy()
    d = fp.D_VALUE
    expect = sum((1 + 0.001 * k) * C**iters + d * (1 - C**iters) / (1 - C) for k in range(chains))
    np.testing.assert_allclose(fma, expect, rtol=1e-5)
    add = fp.chain_reference("add", c, n, iters, chains).numpy()
    np.testing.assert_allclose(add, sum(1 + 0.001 * k + iters * C * 0.0005 for k in range(chains)),
                               rtol=1e-5)
    sel = fp.chain_reference("select", c, n, iters, chains).numpy()
    np.testing.assert_allclose(sel, sum(1 + 0.001 * k for k in range(chains)), rtol=1e-6)
    # newton converges to 1 / c
    newton = fp.chain_reference("newton", c, n, 200, chains).numpy()
    np.testing.assert_allclose(newton, chains / C, rtol=1e-6)
    # unroll multiplies the work exactly as more iters do
    np.testing.assert_array_equal(fp.chain_reference("fma", c, n, 10, chains, unroll=4).numpy(),
                                  fp.chain_reference("fma", c, n, 40, chains).numpy())


def test_chain_reads_its_multiplier_per_lane():
    c = fp.multipliers("cpu").clone()
    c[5] = 0.5
    out = fp.chain_reference("add", c, 256, 10, 4).numpy()
    assert out[5] != out[4] and out[5] == out[133] and out[4] == out[132]


def test_chain_wrapper_on_cpu_and_other_devices():
    launches = fp.chain.launches
    c = fp.multipliers("cpu")
    got = fp.chain("newton", c, 128, 20, 8, 4)
    assert torch.equal(got, fp.chain_reference("newton", c, 128, 20, 8, 4))
    assert fp.chain.launches == launches
    with pytest.raises(ValueError, match="cuda or cpu"):
        fp.chain("add", torch.zeros(128, device="meta"), 128, 1, 8)
    with pytest.raises(ValueError, match="unknown op"):
        fp.chain_reference("sqrt", c, 128, 1, 8)


def _fake_card(monkeypatch, gops, ratio, clock_mhz=1980.0):
    """Replace the card's measurements: ``gops`` per op, and times that grow
    by ``ratio`` from 1x to 4x iters."""

    def measure(op, blocks_per_sm, chains, unroll, iters, reps=3):
        time_s = 1.0 * (iters / fp.ITERS_QUICK) ** (np.log(ratio) / np.log(4))
        return {"op": op, "blocks_per_sm": blocks_per_sm, "threads": 128 * 132 * blocks_per_sm,
                "chains": chains, "unroll": unroll, "iters": iters, "time_s": time_s,
                "gops": gops[op] * (unroll / 64), "gflops": 0.0}

    monkeypatch.setattr(fp, "measure", measure)
    monkeypatch.setattr(fp, "physics_bound", lambda: {
        "sms": 132, "fp32_lanes_per_sm": 128, "max_sm_clock_mhz": clock_mhz,
        "gops": 132 * 128 * clock_mhz / 1e3, "gflops": 2 * 132 * 128 * clock_mhz / 1e3})
    monkeypatch.setattr(fp.torch.cuda, "get_device_name", lambda i=0: "a card")


def test_run_accepts_a_reading_under_the_physics_bound(monkeypatch):
    _fake_card(monkeypatch, {"fma": 33000.0, "add": 33100.0, "select": 16000.0,
                             "newton": 32900.0}, ratio=4.0)
    out = fp.run(fp.ITERS_QUICK)
    assert out["ok"] and out["over_physics"] == []
    assert out["add_gops"] == 33100.0 and out["best_shape"]["add"][2] == 64
    assert out["iters_scaling"]["linear"] and np.isclose(out["iters_scaling"]["time_ratio_4x"], 4.0)
    assert len(out["sweep"]) == len(fp.OPS) * len(fp.SWEEP)


@pytest.mark.parametrize("gops,ratio,why", [
    ({"fma": 36000.0, "add": 33000.0, "select": 16000.0, "newton": 33000.0}, 4.0, "physics"),
    ({"fma": 33000.0, "add": 33000.0, "select": 16000.0, "newton": 33000.0}, 2.0, "linear"),
])
def test_run_rejects_an_implausible_reading(monkeypatch, gops, ratio, why):
    _fake_card(monkeypatch, gops, ratio)
    out = fp.run(fp.ITERS_QUICK)
    assert not out["ok"]
    if why == "physics":
        assert out["over_physics"] == ["fma"]
    else:
        assert not out["iters_scaling"]["linear"]


def test_main_without_a_card(monkeypatch):
    monkeypatch.setattr(fp.torch.cuda, "is_available", lambda: False)
    assert fp.main([]) == 2
