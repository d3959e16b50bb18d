"""Live progress reporting for long builds.

The reference renders 1/2/3-bar terminal progress with ETA estimators
(/root/reference/src/helpers.cpp:7-135, sequence-count sampling at
src/count_kmers13.cpp:479-536). The device build streams fixed-size chunks, so
progress is exact: bytes dispatched / total bytes, with throughput and ETA
from a monotonic clock. Renders an in-place bar on a TTY; falls back to
rate-limited log lines otherwise (build logs stay readable under nohup/CI).
"""

from __future__ import annotations

import logging
import sys
import time

logger = logging.getLogger("aindex_tpu.progress")


class Progress:
    """Single-phase progress reporter over a known byte total.

    ``step(done)`` takes the *absolute* number of bytes processed so far
    (chunk loops know their offset); rendering is rate-limited to
    ``interval`` seconds. Use as a context manager to guarantee the final
    100% line.
    """

    def __init__(self, total: int, label: str, interval: float = 1.0,
                 stream=None, enabled: bool | None = None):
        self.total = max(int(total), 1)
        self.label = label
        self.interval = interval
        self.stream = stream if stream is not None else sys.stderr
        self.enabled = enabled if enabled is not None else True
        self._tty = bool(getattr(self.stream, "isatty", lambda: False)())
        self._t0 = time.monotonic()
        self._last = 0.0
        self._done = 0
        self._rendered = False

    def __enter__(self) -> "Progress":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def step(self, done: int) -> None:
        self._done = min(int(done), self.total)
        now = time.monotonic()
        if now - self._last < self.interval and self._done < self.total:
            return
        self._last = now
        self._render(now)

    def add(self, nbytes: int) -> None:
        self.step(self._done + nbytes)

    def _render(self, now: float) -> None:
        if not self.enabled:
            return
        elapsed = max(now - self._t0, 1e-9)
        frac = self._done / self.total
        rate = self._done / elapsed
        eta = (self.total - self._done) / rate if rate > 0 else float("inf")
        msg = (f"{self.label}: {frac * 100:5.1f}% "
               f"({self._done / 1e6:.1f}/{self.total / 1e6:.1f} MB, "
               f"{rate / 1e6:.1f} MB/s, ETA {eta:.0f}s)")
        if self._tty:
            bar_w = 30
            fill = int(bar_w * frac)
            self.stream.write(f"\r[{'#' * fill}{'.' * (bar_w - fill)}] {msg}")
            self.stream.flush()
            self._rendered = True
        else:
            logger.info("%s", msg)

    def close(self) -> None:
        self._done = self.total
        self._render(time.monotonic())
        if self._rendered and self._tty:
            self.stream.write("\n")
            self.stream.flush()


def make_progress(total: int, label: str, enabled: bool) -> Progress | None:
    """Callback-style factory: None when progress is off (the chunk loops
    accept ``on_progress=None`` and skip the calls entirely)."""
    return Progress(total, label) if enabled else None
