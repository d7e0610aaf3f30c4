"""Wall-clock step timing (covers the reference's lib/utils/timer.py surface).

The engines time two things: a single region (``tic``/``toc`` pairs) and the
running mean across calls, which the CLIs print as "Ns / iter".  Implemented
here as a running-stats accumulator over ``time.perf_counter`` (monotonic, not
subject to wall-clock jumps like the reference's ``time.time``); the object is
also usable as a context manager.
"""

from __future__ import annotations

from time import perf_counter


class Timer:
    """Accumulates durations of ``tic``/``toc`` regions and their mean."""

    __slots__ = ("_t0", "diff", "calls", "total_time")

    def __init__(self) -> None:
        self._t0 = None
        self.diff = 0.0
        self.calls = 0
        self.total_time = 0.0

    @property
    def average_time(self) -> float:
        return self.total_time / self.calls if self.calls else 0.0

    def tic(self) -> "Timer":
        self._t0 = perf_counter()
        return self

    def toc(self, average: bool = True) -> float:
        if self._t0 is None:
            raise RuntimeError("toc() without a matching tic()")
        self.diff = perf_counter() - self._t0
        self.calls += 1
        self.total_time += self.diff
        return self.average_time if average else self.diff

    # Context-manager sugar: ``with timer: <region>``.
    def __enter__(self) -> "Timer":
        return self.tic()

    def __exit__(self, *exc) -> None:
        self.toc()
