"""The port's tracing: spans and counters recorded inside the program
(counterpart of ``utils/profiler.py``, the reference's Tracy zones).

Recording is on while profiling is on (``set_profiling``, ``ZWRT_PROFILE=1``
or the CLI's ``--profile=host``) or while a ``torch.profiler`` capture is
running in the process (the CLI's ``--profile=device``, the benchmark's
traced window).  When it is off, ``named_zone`` and ``count`` do nothing:
no clock read, no ``record_function``.

A span (``named_zone``) is recorded in memory with its name, start and
end (Unix nanoseconds, the clock of ``torch.profiler``'s trace), its
parent span and the image it belongs to; the span ``render_device`` opens
with ``image=True`` (``Renderer::render``) gives each image its id.  Each
span is also a ``torch.profiler.record_function``, so it lies in the
profiler's trace beside the kernels.  A counter (``count``) adds a host
integer, or a device scalar that stays on the card until ``snapshot()``
reads it, so nothing on the render path waits for the card.
``snapshot()`` returns what was recorded; ``reset_zones()`` clears it.

``format_zone_summary`` prints the spans' host statistics by name and
the counters (``--profile=host``).  ``run_with_device_trace`` runs a
function under ``torch.profiler`` with CUDA activity and returns the
device time of each kernel by name (``fused_render_kernel``,
``bounce_kernel``, ``closest_hit_kernel``; other kernels under their own
names) and the device's idle time by the innermost span at the middle of
each idle gap (``--profile=device``); ``format_device_summary`` and
``format_idle_summary`` print them.
"""

from __future__ import annotations

import contextlib
import os
import re
import time

import torch

_enabled = os.environ.get("ZWRT_PROFILE", "0") not in ("", "0", "false")

# span records [name, start_ns, end_ns, parent index or -1, image id or -1],
# the indices of the open spans, the images begun, and the counters: host
# integers and device scalars
_spans: list = []
_open: list = []
_images = [0]
_counters: dict = {}
_device_counters: dict = {}

OUTSIDE = "outside any span"


def set_profiling(enabled: bool) -> None:
    global _enabled
    _enabled = bool(enabled)


def profiling_enabled() -> bool:
    return _enabled


def recording() -> bool:
    """Whether spans and counters are recorded now: profiling is on, or a
    ``torch.profiler`` capture is running."""
    return _enabled or torch.autograd._profiler_enabled()


@contextlib.contextmanager
def named_zone(name: str, image: bool = False):
    """A span of the enclosed block while recording; nothing otherwise.
    ``image``: the span of one image, which takes a new image id unless it
    lies inside another image's span; every span inside it carries that
    id."""
    if not recording():
        yield
        return
    parent = _open[-1] if _open else -1
    image_id = _spans[parent][4] if parent >= 0 else -1
    if image and image_id < 0:
        image_id = _images[0]
        _images[0] += 1
    # the start is read after record_function's entry and the end after its
    # exit: each of them takes its event's timestamp early (on an H100's
    # host, 6-55 us before it returns against 10-100 us after it is called)
    rec = [name, 0, 0, parent, image_id]
    _open.append(len(_spans))
    _spans.append(rec)
    try:
        with torch.profiler.record_function(name):
            rec[1] = time.time_ns()
            yield
    finally:
        rec[2] = time.time_ns()
        _open.pop()


def count(name: str, n=1) -> None:
    """Adds ``n`` to counter ``name`` while recording: a host integer, or a
    device scalar summed on its device and read only by ``snapshot``."""
    if not recording():
        return
    if isinstance(n, torch.Tensor):
        prev = _device_counters.get(name)
        _device_counters[name] = n if prev is None else prev + n
    else:
        _counters[name] = _counters.get(name, 0) + int(n)


def snapshot() -> dict:
    """What was recorded: ``spans``, a list of {name, start_ns, end_ns,
    parent, image_id} (``parent`` an index into the list, -1 for none; the
    end of a span still open is 0), ``counters`` {name: int} (device
    counters read now, which waits for the card) and ``images``, the image
    ids given."""
    counters = dict(_counters)
    for name, v in _device_counters.items():
        counters[name] = counters.get(name, 0) + int(v.item())
    spans = [dict(zip(("name", "start_ns", "end_ns", "parent", "image_id"), s)) for s in _spans]
    return {"spans": spans, "counters": counters, "images": _images[0]}


def reset_zones() -> None:
    """Clears the spans, the counters and the image ids."""
    _spans.clear()
    _open.clear()
    _images[0] = 0
    _counters.clear()
    _device_counters.clear()


def zone_summary() -> dict:
    """{span name: (count, total_s, min_s, max_s)} over the finished spans."""
    out: dict = {}
    for name, t0, t1, _, _ in _spans:
        if not t1:
            continue
        dt = (t1 - t0) / 1e9
        z = out.get(name)
        out[name] = (1, dt, dt, dt) if z is None else (
            z[0] + 1, z[1] + dt, min(z[2], dt), max(z[3], dt))
    return out


def format_zone_summary() -> str:
    """Per-span host statistics (sorted by total time), then the
    counters."""
    zones = zone_summary()
    if not zones:
        return "no profiler zones recorded (is ZWRT_PROFILE/--profile on?)"
    rows = sorted(zones.items(), key=lambda kv: -kv[1][1])
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
    counters = snapshot()["counters"]
    if counters:
        name_w = max(7, max(len(k) for k in counters))
        lines.append(f"{'counter':<{name_w}}  {'value':>20}")
        lines += [f"{k:<{name_w}}  {v:>20}" for k, v in sorted(counters.items())]
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Device-time table (--profile=device): per-kernel device milliseconds from
# a torch.profiler capture, and the device's idle time by span, printed
# without a viewer
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


def idle_by_span(intervals, t0_ns: int, t1_ns: int, spans) -> dict:
    """{span name or ``OUTSIDE``: idle ms}: the gaps in [t0_ns, t1_ns] that
    no device interval ((start_ns, end_ns) pairs) covers, each put down to
    the innermost of ``spans`` (``snapshot``'s records) that holds the
    gap's middle (the shortest such span)."""
    gaps, cursor = [], t0_ns
    for s, e in sorted((max(s, t0_ns), min(e, t1_ns)) for s, e in intervals):
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if t1_ns > cursor:
        gaps.append((cursor, t1_ns))
    idle: dict = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        inside = [sp for sp in spans if sp["start_ns"] <= mid <= sp["end_ns"]]
        name = (min(inside, key=lambda sp: sp["end_ns"] - sp["start_ns"])["name"]
                if inside else OUTSIDE)
        idle[name] = idle.get(name, 0.0) + (e - s) / 1e6
    return idle


def format_idle_summary(idle: dict) -> str:
    """The device's idle ms by span (sorted by idle time)."""
    if not idle:
        return "the device was never idle under the capture"
    rows = sorted(idle.items(), key=lambda kv: -kv[1])
    name_w = max(9, max(len(k) for k, _ in rows))
    lines = [f"{'idle span':<{name_w}}  {'idle':>10}"]
    lines += [f"{name:<{name_w}}  {ms:>8.2f}ms" for name, ms in rows]
    lines.append(f"{'TOTAL':<{name_w}}  {sum(idle.values()):>8.2f}ms")
    return "\n".join(lines)


def run_with_device_trace(fn):
    """Run ``fn()`` under ``torch.profiler`` (CUDA activity when a card is
    present); returns (result, {zone: (count, total_ms)} over the device
    kernels it launched, ``idle_by_span`` over the run)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    first = len(_spans)
    with profile(activities=activities) as prof:
        t0 = time.time_ns()
        result = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t1 = time.time_ns()
    # the card's kernels, copies and fills; not the spans' ranges that the
    # trace repeats on the card's timeline
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == cuda and not e.is_user_annotation()]
    agg = aggregate_device_events((e.name(), e.duration_ns() / 1e3) for e in events)
    idle = idle_by_span([(e.start_ns(), e.end_ns()) for e in events], t0, t1,
                        snapshot()["spans"][first:])
    return result, agg, idle
