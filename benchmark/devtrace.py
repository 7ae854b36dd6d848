"""The device trace of a traced window: ``torch.profiler`` with CPU and CUDA
activity, exported as a Chrome trace and reduced here.

``profile(fn)`` runs ``fn`` inside a ``bench.window`` annotation under the
profiler and returns (fn's result, ``summarize``'s dict):

  * ``window_s``: the annotation's length; ``busy_s``: the union of the
    device's kernel, memcpy and memset intervals inside it;
  * ``kernels``: {kernel: (launches, seconds)}, a kernel named by its
    function name without template or argument lists, so that every
    instantiation of one kernel counts together;
  * ``device_ops``: the ten kernels that took most time, [[name, seconds]];
  * ``idle_gaps``: the device's idle time inside the window by what the
    host was doing, [[name, seconds]], the ten largest: each gap of at
    least ``GAP_US`` is named by the harness stage (``bench.*``) and the
    innermost host operation that span its middle; shorter gaps count
    under ``SHORT_GAPS``.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
GAP_US = 10.0
SHORT_GAPS = f"gaps under {GAP_US:g} us"
MAX_NAMED_GAPS = 20000


def kernel_name(name: str) -> str:
    """``void ns::kernel<...>(args)`` -> ``ns::kernel``."""
    name = name.replace("(anonymous namespace)::", "").strip()
    if name.startswith("void "):
        name = name[5:]
    for stop in ("<", "("):
        if stop in name:
            name = name[: name.index(stop)]
    return name.strip() or "(unnamed)"


def profile(fn):
    import torch
    from torch.profiler import ProfilerActivity, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with record_function("bench.window"):
            result = fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return result, summarize(events)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events) -> dict:
    """Reduce Chrome-trace events (dicts with ph, cat, name, ts, dur in us)."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
    notes = [e for e in xs if e.get("cat") == "user_annotation"]
    win = [e for e in notes if e.get("name") == "bench.window"]
    if not win:
        raise ValueError("the trace has no bench.window annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [e for e in xs if str(e.get("cat", "")).lower() in DEVICE_CATS]
    kernels: dict = {}
    spans = []
    for e in dev:
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e["dur"]), w1)
        if t <= s:
            continue
        spans.append((s, t))
        k = kernel_name(str(e.get("name", "")))
        n, sec = kernels.get(k, (0, 0.0))
        kernels[k] = (n + 1, sec + (t - s) / 1e6)
    busy = _merge(spans)
    busy_us = sum(e - s for s, e in busy)
    gaps = []
    cursor = w0
    for s, e in busy:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if w1 > cursor:
        gaps.append((cursor, w1))
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "kernels": kernels,
        "device_ops": [[k, v[1]] for k, v in
                       sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]],
        "idle_gaps": _name_gaps(gaps, xs),
    }


def _name_gaps(gaps, xs):
    host = [e for e in xs if str(e.get("cat", "")).lower() in HOST_CATS]
    stages = [e for e in xs if e.get("cat") == "user_annotation"
              and str(e.get("name", "")).startswith("bench.") and e.get("name") != "bench.window"]

    def table(evs):
        s = np.array([float(e["ts"]) for e in evs], np.float64)
        return s, s + np.array([float(e["dur"]) for e in evs], np.float64)

    hs, he = table(host) if host else (np.zeros(0), np.zeros(0))
    ss, se = table(stages) if stages else (np.zeros(0), np.zeros(0))
    named: dict = {}
    long = sorted((g for g in gaps if g[1] - g[0] >= GAP_US), key=lambda g: g[0] - g[1])
    short = sum(e - s for s, e in gaps if e - s < GAP_US) + sum(
        e - s for s, e in long[MAX_NAMED_GAPS:])
    for s, e in long[:MAX_NAMED_GAPS]:
        mid = 0.5 * (s + e)
        inside = np.nonzero((hs <= mid) & (he >= mid))[0]
        op = (str(host[inside[np.argmin(he[inside] - hs[inside])]]["name"]) if inside.size
              else "no host op")
        inside = np.nonzero((ss <= mid) & (se >= mid))[0]
        stage = (str(stages[inside[np.argmin(se[inside] - ss[inside])]]["name"])
                 if inside.size else "between requests")
        name = f"{stage}: {op}"
        named[name] = named.get(name, 0.0) + (e - s) / 1e6
    if short:
        named[SHORT_GAPS] = named.get(SHORT_GAPS, 0.0) + short / 1e6
    return [[k, v] for k, v in sorted(named.items(), key=lambda kv: -kv[1])[:10]]
