"""The program's own spans and counters in the traced run, and the
arithmetic on them that their readers share.

The program records spans and counters while a profiler records
(``openmmtools_tpu_torch.utils.tracing``), so the traced run's profiled
unit leaves them in the program's buffer; a reader takes its
``snapshot()``. A span is (name, start ns, end ns, cause, thread) on the
profiler's host clock. A program that records none (it lacks the module,
or the unit ran no such span) gives None, and the harness leaves the
metric out.

* A span name's self time is the time in which a span of that name is the
  innermost open span: of the spans open at an instant, on any thread, the
  one that started last. So a span's self time is its duration less the
  spans inside it, those on autograd's worker thread included, and a span
  nested in one of its own name counts once.
* Per-iteration figures sum what lies inside the ``sampler.iteration``
  spans and divide by their number.
"""
from __future__ import annotations

import collections

ITERATION = "sampler.iteration"


def snapshot():
    """The program's snapshot, or None where the program has no tracing."""
    try:
        from openmmtools_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def merged(intervals):
    """The union of (lo, hi) intervals as sorted disjoint [lo, hi]."""
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def intersect(a, b):
    """The intersection of two merged unions, merged."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out.append([lo, hi])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def length(intervals):
    return sum(hi - lo for lo, hi in intervals)


def of(spans, names):
    """The merged intervals of the spans named in ``names``."""
    return merged((s[1], s[2]) for s in spans if s[0] in names)


def iterations(spans):
    return sum(s[0] == ITERATION for s in spans)


def covered_ns(spans, names, within=(ITERATION,)):
    """Nanoseconds inside some span of ``names`` and inside some span of
    ``within``."""
    return length(intersect(of(spans, names), of(spans, within)))


def innermost_ns(spans):
    """Nanoseconds in which each name is the innermost open span, inside
    the iteration spans: {name: ns}."""
    out = collections.Counter()
    order = sorted(spans, key=lambda s: (s[1], -s[2]))
    bounds = sorted({t for s in spans for t in (s[1], s[2])})
    active, k = [], 0
    for lo, hi in zip(bounds, bounds[1:]):
        while k < len(order) and order[k][1] <= lo:
            active.append(order[k])
            k += 1
        active = [s for s in active if s[2] > lo]
        if not any(s[0] == ITERATION for s in active):
            continue
        inner = max(active, key=lambda s: (s[1], -s[2]))
        out[inner[0]] += hi - lo
    return out


def innermost_at(spans, t):
    """The innermost span open at ``t`` (None where none is)."""
    open_ = [s for s in spans if s[1] <= t < s[2]]
    return max(open_, key=lambda s: (s[1], -s[2])) if open_ else None


def per_iteration_ms(ns, spans):
    n = iterations(spans)
    return None if n == 0 else 1e-6 * ns / n


def self_ms(name, snap=None):
    """Self time of ``name`` in ms an iteration; None without the span."""
    snap = snapshot() if snap is None else snap
    if snap is None or not any(s[0] == name for s in snap.spans):
        return None
    return per_iteration_ms(innermost_ns(snap.spans)[name], snap.spans)


def span_ms(names, snap=None):
    """Time inside the spans ``names`` in ms an iteration (nested spans
    counted once); None without them."""
    snap = snapshot() if snap is None else snap
    if snap is None or not any(s[0] in names for s in snap.spans):
        return None
    return per_iteration_ms(covered_ns(snap.spans, names), snap.spans)


def less_ms(outer, inner, snap=None):
    """Time inside ``outer`` spans and outside ``inner`` spans, in ms an
    iteration; None without ``outer`` spans."""
    snap = snapshot() if snap is None else snap
    if snap is None or not any(s[0] == outer for s in snap.spans):
        return None
    spans = snap.spans
    outside = covered_ns(spans, {outer}) - length(intersect(
        intersect(of(spans, {outer}), of(spans, {inner})),
        of(spans, {ITERATION})))
    return per_iteration_ms(outside, spans)


def ratio(numerator, denominator, snap=None):
    """counters[numerator] / counters[denominator]; None without them."""
    snap = snapshot() if snap is None else snap
    if snap is None:
        return None
    c = snap.counters
    if numerator not in c or not c.get(denominator):
        return None
    return c[numerator] / c[denominator]
