"""One step of a bound integrator's step program as a CUDA graph.

Eagerly, the host sets the pace of a sweep-mode step: a batched step of
nine replicas of a 24,000-atom water box issues some 13,000 small ATen
calls (the remainder under ``torch.func.vmap`` and autograd, the Ewald
structure factors, SETTLE), and the device waits for most of them. Here one
step is captured once as a CUDA graph (``torch.cuda.CUDAGraph``) and
replayed once a step: the same operators and hand-written kernels, in the
same order, on the same inputs, drawing the same random numbers, with no
host work between them.

A :class:`StepGraph` holds fixed buffers of every tensor a step reads
(positions, velocities, kT, box, the global parameters, the cached forces
and potentials, the heat, work and acceptance accumulators, the sweep
state) and one generator a replica. Its body is the step program on the
buffers followed by a ``copy_`` of each output into its buffer, so that
replays chain with no host work. :meth:`StepGraph.run` copies a state into
the buffers and the caller's generators' states into the graph's, replays
``count`` times, then clones the outputs into the returned state and hands
the generators' states back: each replay draws what the eager step would
draw at that point of the generator's stream.

The graph is captured at its first use, after the program's first step of
the state's shapes ran eagerly: that step makes what the capture records
and cannot make itself (K2's scratch, tickets and launch counters, the
libraries' plans). The capture holds back the step's tracing counts
(:func:`openmmtools_tpu_torch.utils.tracing.held`), and each replay adds
them, reading the device counts from the graph's own tensors. K2 and
SETTLE count their launches on the device, so their counters see each
replay's launches as they run. Which programs and states a graph serves is
:meth:`BoundIntegrator._graph_for`'s to decide.
"""
from __future__ import annotations

import torch

from openmmtools_tpu_torch.utils import tracing

# the state's tensors that a step writes, and those it only reads
WRITTEN = ("positions", "velocities", "heat", "shadow_work", "protocol_work",
           "n_accepted", "n_proposed", "sweep_snap", "sweep_nblk")
READ = ("kT", "box", "lambda_", "sweep_perm", "sweep_inv", "sweep_excl",
        "sweep_par")


class CaptureError(RuntimeError):
    """The step could not be captured as a CUDA graph; it runs eagerly."""


def _generators(state):
    g = state.generator
    return tuple(g) if isinstance(g, (tuple, list)) else (g,)


def _tensors(state):
    """Every tensor of ``state`` that a step reads, in a fixed order."""
    return ([getattr(state, f) for f in WRITTEN + READ]
            + list(state.global_params.values()) + list(state.forces)
            + list(state.potentials))


def signature(state, n_groups, skip):
    """The key of the graph that serves ``state``: each tensor's shape and
    dtype, the parameters' names, the generators' count and ``skip``; None
    where no graph can: a state off the card, a field that is not a tensor,
    no cached forces, a generator that is not a card generator of the
    state's device, or one generator serving two replicas (the graph gives
    each replica a generator of its own)."""
    dev = state.positions.device
    if dev.type != "cuda" or not isinstance(state.global_params, dict):
        return None
    if len(state.forces) != n_groups or len(state.potentials) != n_groups:
        return None
    gens = _generators(state)
    # a generator made for "cuda" has no index: the current card's
    if not all(isinstance(g, torch.Generator) and g.device.type == "cuda"
               and g.device.index in (None, dev.index) for g in gens):
        return None
    if len({id(g) for g in gens}) != len(gens):
        return None
    tensors = _tensors(state)
    if not all(isinstance(t, torch.Tensor) and t.device == dev
               for t in tensors):
        return None
    return (tuple((tuple(t.shape), t.dtype) for t in tensors),
            tuple(state.global_params), len(gens),
            isinstance(state.generator, (tuple, list)), skip)


class StepGraph:
    """One step of ``bound``'s program on fixed buffers shaped like
    ``state``: :meth:`body` runs it eagerly on any device, :meth:`capture`
    records it as a CUDA graph and :meth:`run` replays it."""

    def __init__(self, bound, state, skip, key=None):
        self.bound = bound
        self.skip = skip
        self.key = key                      # the signature it serves
        self.generators = tuple(torch.Generator(device=g.device)
                                for g in _generators(state))
        batch = isinstance(state.generator, (tuple, list))
        self.bufs = state.replace(
            **{f: getattr(state, f).clone() for f in WRITTEN + READ},
            global_params={k: v.clone()
                           for k, v in state.global_params.items()},
            forces=tuple(f.clone() for f in state.forces),
            potentials=tuple(u.clone() for u in state.potentials),
            sweep_overflow=None, step_count=0,
            generator=self.generators if batch else self.generators[0])
        self.graph = None
        self.held = []                      # the counts a replay adds

    def load(self, state):
        """Copy ``state``'s tensors into the buffers and its generators'
        states into the graph's generators."""
        for buf, t in zip(_tensors(self.bufs), _tensors(state)):
            buf.copy_(t)
        for mine, g in zip(self.generators, _generators(state)):
            mine.set_state(g.get_state())

    def body(self):
        """One step of the program on the buffers, each output copied into
        its buffer: the captured work. Raises where the step replaces a
        field it only reads or changes a field's shape or type."""
        b = self.bufs
        out = self.bound._step(b, self.skip)
        if (out.global_params is not b.global_params
                or any(getattr(out, f) is not getattr(b, f) for f in READ)):
            raise CaptureError("the step replaced a field it only reads")
        pairs = ([(getattr(b, f), getattr(out, f)) for f in WRITTEN]
                 + list(zip(b.forces, out.forces))
                 + list(zip(b.potentials, out.potentials)))
        for buf, new in pairs:
            if new is buf:
                continue
            if new.shape != buf.shape or new.dtype != buf.dtype:
                raise CaptureError(
                    f"the step turns a {buf.dtype} {tuple(buf.shape)} field "
                    f"into {new.dtype} {tuple(new.shape)}")
            buf.copy_(new)

    def unload(self, state, count):
        """``state`` advanced by the ``count`` steps in the buffers: clones
        of the written tensors, and the generators' states handed back."""
        for g, mine in zip(_generators(state), self.generators):
            g.set_state(mine.get_state())
        b = self.bufs
        return state.replace(
            **{f: getattr(b, f).clone() for f in WRITTEN},
            forces=tuple(f.clone() for f in b.forces),
            potentials=tuple(u.clone() for u in b.potentials),
            step_count=state.step_count + count)

    def capture(self):
        """Capture :meth:`body` with the graph's generators registered,
        once an eager step of the same shapes has run; the step's tracing
        counts are kept for the replays. Raises :class:`CaptureError` where
        the capture fails; a fault of the device raises as itself."""
        dev = self.bufs.positions.device
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        try:
            with (torch.cuda.device(dev), tracing.held() as held,
                  torch.cuda.graph(graph)):
                self.body()
        except CaptureError:
            raise
        except RuntimeError as err:
            # a fault of the device is sticky and raises again here; a
            # capture the runtime refused leaves the device usable
            torch.cuda.synchronize(dev)
            raise CaptureError(str(err)) from err
        self.graph, self.held = graph, held
        tracing.count("integrator.graph_captures")

    def run(self, state, count):
        """``state`` advanced ``count`` steps by as many replays, each in
        an ``integrator.step`` span."""
        self.load(state)
        for _ in range(count):
            with tracing.span("integrator.step"):
                self.graph.replay()
                if tracing.enabled():
                    for name, n in self.held:
                        tracing.count(name, n)
        tracing.count("integrator.steps", count)
        tracing.count("integrator.graph_steps", count)
        return self.unload(state, count)
