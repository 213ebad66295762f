"""The traced run's instruments: named host ranges, synchronized spans, and
the profiler's attribution of device time.

:class:`marked` wraps functions of the program from the outside, for the
length of a ``with`` block, so that each call opens a profiler range (a
``record_function``) or, with ``sync``, also adds its wall time, ended by a
``torch.cuda.synchronize()``, to a span. :func:`profile` runs a unit of
work under ``torch.profiler`` and attributes each device activity to the
innermost marked range that was open on the host when it was launched: the
launch's runtime call, found by its correlation id, or else the operator it
is linked to. That attribution is a copy of ``profile_steps`` in
``chip_smoke.py``, kept here so that the yardstick cannot move with it.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Tuple

import torch


class marked:
    """Within the block, every call of ``getattr(obj, name)`` for each
    ``label: (obj, name)`` of ``marks`` runs inside a profiler range
    ``label``; with ``sync`` the block instead adds each call's wall time,
    synchronized at its end, to ``spans[label]``."""

    def __init__(self, marks, sync=False):
        self.marks = {label: (obj, name) for label, (obj, name)
                      in marks.items() if obj is not None}
        self.sync = sync
        self.spans: Dict[str, float] = collections.defaultdict(float)
        self._originals = {}

    def __enter__(self):
        from torch.profiler import record_function

        for label, (obj, name) in self.marks.items():
            fn = getattr(obj, name)
            self._originals[label] = (fn, name in vars(obj))
            if self.sync:
                def wrapped(*a, _fn=fn, _label=label, **kw):
                    t0 = time.perf_counter()
                    out = _fn(*a, **kw)
                    torch.cuda.synchronize()
                    self.spans[_label] += time.perf_counter() - t0
                    return out
            else:
                def wrapped(*a, _fn=fn, _label=label, **kw):
                    with record_function(_label):
                        return _fn(*a, **kw)
            setattr(obj, name, wrapped)
        return self

    def __exit__(self, *exc):
        for label, (obj, name) in self.marks.items():
            fn, own = self._originals[label]
            if own:
                setattr(obj, name, fn)
            else:
                delattr(obj, name)
        return False


@dataclasses.dataclass
class Trace:
    """A profiled segment: its wall seconds and units of work, the device
    activities (name, start ns, end ns, range), the marked host ranges
    (name, start ns, end ns), and the ATen operator calls on the host."""

    wall_s: float
    units: int
    work: List[Tuple[str, int, int, str]]
    ranges: List[Tuple[str, int, int]]
    aten_calls: int

    def busy_s(self):
        """Seconds in which some activity ran on the device (the union of
        the activities' intervals)."""
        return sum(hi - lo for lo, hi in self.union()) * 1e-9

    def union(self):
        spans = sorted((s, e) for _, s, e, _ in self.work)
        out = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def device_s(self, match):
        """Device seconds of the activities whose name contains ``match``."""
        return sum(e - s for n, s, e, _ in self.work if match in n) * 1e-9

    def host_s(self, labels):
        """Host seconds inside the ranges ``labels`` (a nested call of the
        same range counted once)."""
        total = 0
        for label in labels:
            end = 0
            for name, lo, hi in sorted((r for r in self.ranges
                                        if r[0] == label),
                                       key=lambda r: r[1]):
                if lo >= end:
                    total += hi - lo
                    end = hi
        return total * 1e-9

    def range_at(self, t):
        inner = None
        for name, lo, hi in self.ranges:
            if lo <= t <= hi and (inner is None or hi - lo < inner[0]):
                inner = (hi - lo, name)
        return "other" if inner is None else inner[1]

    def breakdown(self, top=10):
        """The device operations that took most time, and the idle gaps
        between device activity summed by the host range open at their
        middle: each list of (name, seconds), longest first."""
        ops = collections.Counter()
        for n, s, e, _ in self.work:
            ops[n[:80]] += (e - s) * 1e-9
        gaps = collections.Counter()
        u = self.union()
        for (_, end), (start, _) in zip(u, u[1:]):
            gaps[self.range_at((end + start) // 2)] += (start - end) * 1e-9
        return {"device_ops": [[n, s] for n, s in ops.most_common(top)],
                "idle_gaps": [[n, s] for n, s in gaps.most_common(top)]}


def profile(unit, marks, device):
    """Run ``unit()`` (which returns its units of work) under the profiler
    with ``marks`` as ranges; returns a :class:`Trace`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize(device)
    with marked(marks):
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            units = unit()
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
    labels = set(marks)
    events = prof.profiler.kineto_results.events()
    host = [e for e in events if e.device_type() == DeviceType.CPU]
    ranges = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in host if e.name() in labels]
    # the runtime's launch calls (cudaLaunchKernel, cuLaunchKernelEx,
    # cudaMemcpyAsync, ...) carry the correlation id of the device activity
    # they start; operators carry ids of their own
    launches, ops = {}, {}
    for e in host:
        table = launches if e.name().startswith("cu") else ops
        table[e.correlation_id()] = e.start_ns()
    trace = Trace(wall_s=wall, units=units, work=[], ranges=ranges,
                  aten_calls=sum(e.name().startswith("aten::") for e in host))
    for e in events:
        # device work: kernels, copies and fills (the ranges also show on
        # the device as spans, which are not work)
        if e.device_type() != DeviceType.CUDA or e.name() in labels:
            continue
        t = launches.get(e.correlation_id(),
                         ops.get(e.linked_correlation_id()))
        where = "other" if t is None else trace.range_at(t)
        trace.work.append((e.name(), e.start_ns(),
                           e.start_ns() + e.duration_ns(), where))
    return trace
