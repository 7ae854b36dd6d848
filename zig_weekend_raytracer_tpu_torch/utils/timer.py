"""Wall-clock stage timing (the port's own copy of ``utils/timer.py``;
reference: src/timer.zig)."""

from __future__ import annotations

import logging
import time

log = logging.getLogger("zwrt")


class Timer:
    """Logs elapsed milliseconds per pipeline stage, matching the reference's
    scene-init / render / write logs (src/main.zig:94,97,105)."""

    def __init__(self) -> None:
        self._start = time.monotonic()
        self._last = self._start

    def elapsed_ms(self) -> float:
        return (time.monotonic() - self._last) * 1000.0

    def total_ms(self) -> float:
        return (time.monotonic() - self._start) * 1000.0

    def log_info_elapsed(self, message: str) -> float:
        ms = self.elapsed_ms()
        log.info("[%0.3f ms]\t%s", ms, message)
        self._last = time.monotonic()
        return ms
