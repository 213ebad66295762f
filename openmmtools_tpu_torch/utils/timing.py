"""Named timers (counterpart of ``utils/timing.py``).

openmmtools' ``Timer`` and the ``time_it`` / ``with_timer`` decorators:
named start/stop intervals accumulated into a registry of completed
intervals, with a ``report_timing`` summary. Work on the card is
asynchronous, so a caller timing it synchronizes
(``torch.cuda.synchronize()``) before ``stop``; nothing here synchronizes.
"""
from __future__ import annotations

import functools
import logging
import time
from typing import Callable, Dict, List

logger = logging.getLogger(__name__)


class Timer:
    """Accumulate named timing intervals.

    >>> t = Timer()
    >>> t.start("propagate")
    >>> t.stop("propagate")  # doctest: +SKIP
    >>> t.report_timing()    # doctest: +SKIP
    """

    def __init__(self) -> None:
        self.reset_timing_statistics()

    def reset_timing_statistics(self, benchmark_id: str | None = None) -> None:
        if benchmark_id is None:
            self._t0: Dict[str, float] = {}
            self._completed: Dict[str, List[float]] = {}
        else:
            self._t0.pop(benchmark_id, None)
            self._completed.pop(benchmark_id, None)

    def start(self, benchmark_id: str) -> None:
        self._t0[benchmark_id] = time.perf_counter()

    def stop(self, benchmark_id: str) -> float:
        try:
            t0 = self._t0.pop(benchmark_id)
        except KeyError:
            logger.warning("Timer.stop(%r) without start", benchmark_id)
            return 0.0
        elapsed = time.perf_counter() - t0
        self._completed.setdefault(benchmark_id, []).append(elapsed)
        return elapsed

    def partial(self, benchmark_id: str) -> float:
        """Elapsed time of a still-running interval."""
        return time.perf_counter() - self._t0[benchmark_id]

    def report_timing(self, clear: bool = True) -> Dict[str, float]:
        """{benchmark_id: total seconds}, logged at DEBUG level."""
        totals = {k: sum(v) for k, v in self._completed.items()}
        for k, v in totals.items():
            logger.debug("%s took %.3f s (%d calls)", k, v,
                         len(self._completed[k]))
        if clear:
            self.reset_timing_statistics()
        return totals


def time_it(fn: Callable) -> Callable:
    """Decorator logging the wall time of each call at DEBUG level."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        logger.debug("%s took %.6f s", fn.__name__, time.perf_counter() - t0)
        return out

    return wrapper


def with_timer(benchmark_id: str):
    """:func:`time_it` with an explicit name."""

    def decorator(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            logger.debug("%s took %.6f s", benchmark_id,
                         time.perf_counter() - t0)
            return out

        return wrapper

    return decorator
