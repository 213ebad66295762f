"""Spans and counters inside the program, on the profiler's clock.

Tracing is on while a ``torch.profiler`` profile records, or after
:func:`enable` (until :func:`disable`); it is off by default. Off, a
:func:`span` is one read of two module flags and a shared no-op context,
and a :func:`count` does nothing: no profiler range, no allocation, no
launch, no device read.

On, a span records its name, its start and end in ``time.time_ns()``
nanoseconds (the Unix-epoch clock on which the profiler stamps its host
events), its thread and its cause: the innermost span open on its thread
when it opened or, on a thread with none open (autograd's device worker,
where a backward runs), the innermost span open in the program then,
which is the one that called into autograd. While a profiler records, a
span also opens a profiler range of its name, so the program's spans show
in an exported chrome trace beside the kernels. The range is of function
scope: a user-scope range (``record_function``) would also show on the
device as an annotation spanning its kernels, which a trace reader would
take for device work. No span synchronizes or reads the device.

A counter adds a host int or the sum of a device tensor's elements; a
device counter adds the tensor into an int64 accumulator of its shape on
its device (one in-place add, which casts inside the kernel on the card)
and :func:`snapshot` sums and reads the accumulators, once a device. Spans are kept in memory, the newest ``CAPACITY`` of them (the
older are dropped and counted); :func:`snapshot` hands out plain data and
:func:`reset` clears both. The profiler's chrome trace is the operator's
timeline; nothing here writes a file.

The program's spans, each opened inside its cause:

=============================  =============================================
``sampler.iteration``          one iteration of ``MultiStateSampler.run``
                               or of ``MCMCSampler.run``
``sampler.mixing``,            the multistate iteration's phases;
``sampler.propagation``,       ``sampler.report`` is the NaN check, the
``sampler.energy_matrix``,     reporter and the online analysis
``sampler.report``
``move.apply_batch``           an integrator move on a batch of replicas;
``move.apply``                 an integrator move on one replica
                               (``BaseIntegratorMove._apply``)
``move.nan_check``             inside either, the host read of the NaN
                               flags
``integrator.initial_state``,  the bound integrator's calls in
``integrator.run``,            ``apply_batch`` and in each attempt of
``integrator.sampler_states``  ``_attempts``
``integrator.step``            one step of the step program (a batch's)
``integrator.resort``          a re-sort of the sweep ring
``integrator.overflow_check``   the host read of the sweep overflow flag
``integrator.energies_batch``  the energies of (configuration, parameters)
                               pairs: the multistate energy matrix
``forces.sweep``               a sweep-mode evaluation, in it
``k2.evaluate``                the sweep kernels' launches and
``forces.remainder``           the terms around them, forward and backward
``pme.forward``,               the Ewald structure factors, one a
``pme.backward``               configuration
``constraints.positions``,     the constraint solvers, once a (batched)
``constraints.velocities``     call
=============================  =============================================

and its counters: ``k2.rebuilds`` (device), the sort sets whose block bound
a sweep evaluation re-measured, and ``k2.sort_sets`` (host), the sort sets
it evaluated; ``integrator.steps`` (host), every step through the step
program, ``integrator.graph_steps`` (host), those of them replayed from a
CUDA graph (:mod:`openmmtools_tpu_torch.integrators.step_graph`), and
``integrator.graph_captures`` (host), the graphs captured;
``move.restarts`` (host), an integrator move's attempts after the first
on NaN (0 added for each first attempt); ``constraints.settle`` (host),
each SETTLE projection of a configuration or a batch, and
``constraints.settle_kernel`` (host), those of them that launched a
kernel of ``csrc/settle.cu`` (none on the CPU). A replay runs
inside an ``integrator.step`` span and recounts the counts its capture
held back (:func:`held`).
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

CAPACITY = 65536

_enabled = False
_spans: collections.deque = collections.deque(maxlen=CAPACITY)
_dropped = 0
_host_counts: Dict[str, int] = {}
_device_counts: Dict[Tuple[str, torch.device, torch.Size],
                     torch.Tensor] = {}
_local = threading.local()
# the counts held back while a CUDA graph captures (None: count as usual)
_held: Optional[List[Tuple[str, object]]] = None
# the buffer, the dropped count and the host counters are shared with
# autograd's worker threads
_lock = threading.Lock()
# the innermost open span of the thread that last opened or closed one
_context: List[Optional["_Span"]] = [None]


class Snapshot(NamedTuple):
    """What was recorded: ``spans`` as (name, start_ns, end_ns, cause,
    thread), in the order they ended, ``cause`` the name of the causing
    span (None for a root); ``counters`` as {name: int}; ``dropped`` the
    spans the buffer no longer holds."""

    spans: List[Tuple[str, int, int, Optional[str], int]]
    counters: Dict[str, int]
    dropped: int


def enable():
    """Record spans and counters from now on, profiler or not."""
    global _enabled
    _enabled = True


def disable():
    """Record only while a profiler records (the default)."""
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled or _profiler._is_profiler_enabled


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _record(item):
    global _dropped
    with _lock:
        if len(_spans) == _spans.maxlen:
            _dropped += 1
        _spans.append(item)


class _Span:
    __slots__ = ("name", "cause", "start", "range")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.cause = stack[-1] if stack else _context[0]
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = torch._C._profiler._RecordFunctionFast(self.name)
            self.range.__enter__()
        stack.append(self)
        _context[0] = self
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        _context[0] = self.cause
        if self.range is not None:
            self.range.__exit__(None, None, None)
        cause = self.cause
        _record((self.name, self.start, end,
                 None if cause is None else cause.name,
                 threading.get_ident()))
        return False


def span(name: str):
    """A context manager that records the span ``name`` while tracing is
    on, and costs two flag reads while it is off."""
    if _enabled or _profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


def count(name: str, n=1):
    """Add ``n`` to the counter ``name`` while tracing is on: a host int,
    or the elements of an integer or bool tensor, added on its device (no
    host read; one operation, a copy on a shape's first count). Inside
    :func:`held` the count is held back instead."""
    if _held is not None:
        _held.append((name, n))
        return
    if not (_enabled or _profiler._is_profiler_enabled):
        return
    if isinstance(n, torch.Tensor):
        key = (name, n.device, n.shape)
        acc = _device_counts.get(key)
        if acc is None:
            _device_counts[key] = n.to(torch.int64, copy=True)
        else:
            acc.add_(n)
    else:
        with _lock:
            _host_counts[name] = _host_counts.get(name, 0) + int(n)


@contextlib.contextmanager
def held():
    """Within the block every :func:`count` is held back, on or off, into
    the list the block yields, as (name, n): a CUDA graph's capture runs the
    program once without running its work, and the graph's replays count
    the held (name, n), whose device tensors each replay fills anew."""
    global _held
    outer, _held = _held, []
    try:
        yield _held
    finally:
        _held = outer


def _read(values: torch.Tensor) -> List[int]:
    """One host read of a device's counters."""
    return values.tolist()


def snapshot() -> Snapshot:
    """The spans and counters recorded so far, as plain data; the device
    counters are read once a device."""
    counters = dict(_host_counts)
    by_device: Dict[torch.device, list] = collections.defaultdict(list)
    for (name, device, _), acc in _device_counts.items():
        by_device[device].append((name, acc.sum()))
    for items in by_device.values():
        for (name, _), v in zip(items,
                                _read(torch.stack([a for _, a in items]))):
            counters[name] = counters.get(name, 0) + int(v)
    return Snapshot(spans=list(_spans), counters=counters, dropped=_dropped)


def reset():
    """Forget every span and counter (and take up ``CAPACITY`` anew)."""
    global _spans, _dropped
    _spans = collections.deque(maxlen=CAPACITY)
    _dropped = 0
    _host_counts.clear()
    _device_counts.clear()
