"""Profiler zones (counterpart of ``utils/profiler.py``, the reference's
Tracy zones).

``named_zone`` is a no-op unless profiling is on (``set_profiling`` or
``ZWRT_PROFILE=1``).  When on, it accumulates host wall-clock per zone name
(the JAX package's names: ``Renderer::render``, ``rayColorLine``), marks
the zone for ``torch.profiler`` (``record_function``) and, on the card,
opens an NVTX range of the same name.  ``format_zone_summary`` prints the
host table.

``run_with_device_trace`` runs a function under ``torch.profiler`` with
CUDA activity and sums the device time of each kernel by name
(``fused_render_kernel``, ``bounce_kernel``, ``closest_hit_kernel``; other
kernels under their own names); ``format_device_summary`` prints that
table.  Host time around asynchronous device work counts only up to the
launch unless the zone waits for a result.
"""

from __future__ import annotations

import contextlib
import os
import re
import time

import torch

_enabled = os.environ.get("ZWRT_PROFILE", "0") not in ("", "0", "false")

# host-side zone accumulator: name -> [count, total_s, min_s, max_s]
_zones: dict = {}


def set_profiling(enabled: bool) -> None:
    global _enabled
    _enabled = bool(enabled)


def profiling_enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def named_zone(name: str):
    """Zone annotation; no-op unless profiling is enabled."""
    if not _enabled:
        yield
        return
    nvtx = torch.cuda.is_available()
    t0 = time.perf_counter()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
        dt = time.perf_counter() - t0
        z = _zones.get(name)
        if z is None:
            _zones[name] = [1, dt, dt, dt]
        else:
            z[0] += 1
            z[1] += dt
            z[2] = min(z[2], dt)
            z[3] = max(z[3], dt)


def zone_summary() -> dict:
    """{zone: (count, total_s, min_s, max_s)} accumulated so far."""
    return {k: tuple(v) for k, v in _zones.items()}


def reset_zones() -> None:
    _zones.clear()


def format_zone_summary() -> str:
    """Per-zone host statistics table (sorted by total time)."""
    if not _zones:
        return "no profiler zones recorded (is ZWRT_PROFILE/--profile on?)"
    rows = sorted(_zones.items(), key=lambda kv: -kv[1][1])
    name_w = max(4, max(len(k) for k, _ in rows))
    lines = [
        f"{'zone':<{name_w}}  {'count':>7}  {'total':>10}  "
        f"{'mean':>10}  {'min':>10}  {'max':>10}"
    ]
    for name, (n, tot, mn, mx) in rows:
        lines.append(
            f"{name:<{name_w}}  {n:>7}  {tot * 1e3:>8.2f}ms  "
            f"{tot / n * 1e3:>8.2f}ms  {mn * 1e3:>8.2f}ms  "
            f"{mx * 1e3:>8.2f}ms"
        )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Device-time table (--profile=device): per-kernel device milliseconds from
# a torch.profiler capture, printed without a viewer
# ---------------------------------------------------------------------------

_KERNEL_RE = re.compile(r"\b(fused_render_kernel|bounce_kernel|closest_hit_kernel)\b")


def kernel_zone(name: str) -> str:
    """The zone of a device kernel's name: the port's kernels by their own
    name whatever their template arguments, other kernels by their name
    cut to 48 characters."""
    m = _KERNEL_RE.search(name)
    if m:
        return m.group(1)
    return name[:48] or "(unnamed)"


def aggregate_device_events(events) -> dict:
    """{zone: (count, total_ms)} over ``(name, device_us)`` pairs of device
    kernels."""
    agg: dict = {}
    for name, dur_us in events:
        z = agg.setdefault(kernel_zone(str(name)), [0, 0.0])
        z[0] += 1
        z[1] += dur_us / 1e3
    return {k: tuple(v) for k, v in agg.items()}


def format_device_summary(agg: dict) -> str:
    """Per-zone device-time table (sorted by total device ms)."""
    if not agg:
        return "no device trace events captured (no CUDA kernel ran under the capture)"
    rows = sorted(agg.items(), key=lambda kv: -kv[1][1])
    name_w = max(4, max(len(k) for k, _ in rows))
    total = sum(v[1] for v in agg.values())
    lines = [
        f"{'device zone':<{name_w}}  {'count':>7}  {'total':>10}  {'share':>6}"
    ]
    for name, (n, ms) in rows:
        lines.append(
            f"{name:<{name_w}}  {n:>7}  {ms:>8.2f}ms  {ms / max(total, 1e-12):>5.1%}"
        )
    lines.append(f"{'TOTAL':<{name_w}}  {'':>7}  {total:>8.2f}ms")
    return "\n".join(lines)


def run_with_device_trace(fn):
    """Run ``fn()`` under ``torch.profiler`` (CUDA activity when a card is
    present); returns (result, {zone: (count, total_ms)}) over the device
    kernels it launched."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        result = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
              if e.device_type == cuda]
    return result, aggregate_device_events(events)


@contextlib.contextmanager
def trace_to(path: str):
    """Capture a ``torch.profiler`` trace of the enclosed block and write
    it as a Chrome trace to ``path`` (viewable in Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)
