"""Faults planted under the timed path, to show that the check catches them.

Each fault is a context manager that patches the program from the outside
for the length of a ``with`` block. They are used by the tests in
``tests/`` (on the CPU, at a small size) and by :mod:`benchmark.calibrate`
(on the card, at the cell's own size), never by a benchmark run.

* ``stuck``: a step returns its state unchanged.
* ``half_batch``: a batched step advances the first half of its replicas
  and leaves the rest unchanged.
* ``altered_forces``: the forces a run returns have two atoms' rows
  swapped (an answer altered where it is produced).
* ``altered_matrix``: the energy matrix has the first replica's entry at
  the first state swapped with the last replica's at the last state.
* ``duplicated_state``: mixing gives the second replica the first one's
  state, so the map is no permutation.
* ``no_constraints``: a step runs without its position constraints.
* ``hot_state``: the whole state runs 10 % hot (its kT, which the O
  substep's noise follows, is 1.1 times the one the program was given).
* ``wrong_lambdas``: every evaluation of a batched step reads the first
  replica's global parameters (its lambdas) instead of its own.

Each driver (``traffic/<kind>.py``) lists in ``FAULTS`` the faults its
cells can have.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def patched(obj, name, make):
    """``obj.name`` replaced by ``make(original)`` within the block."""
    original = getattr(obj, name)
    own = name in vars(obj)
    setattr(obj, name, make(original))
    try:
        yield
    finally:
        if own:
            setattr(obj, name, original)
        else:
            delattr(obj, name)


def _bound_class():
    from openmmtools_tpu_torch.integrators.langevin import BoundIntegrator

    return BoundIntegrator


def stuck():
    return patched(_bound_class(), "step",
                   lambda step: lambda self, state, **kw: state)


def half_batch():
    import torch

    def make(step):
        def half(self, state, **kw):
            new = step(self, state, **kw)
            if state.positions.dim() != 3:
                return new
            h = state.positions.shape[0] // 2
            keep = lambda a, b: torch.cat([a[:h], b[h:]])  # noqa: E731
            return new.replace(
                positions=keep(new.positions, state.positions),
                velocities=keep(new.velocities, state.velocities))
        return half
    return patched(_bound_class(), "step", make)


def altered_forces():
    def make(run):
        def altered(self, state, n_steps):
            out = run(self, state, n_steps)
            f = out.forces[0].clone()
            f[..., [0, 1], :] = f[..., [1, 0], :]
            return out.replace(forces=(f,) + tuple(out.forces[1:]))
        return altered
    return patched(_bound_class(), "run", make)


def altered_matrix():
    from openmmtools_tpu_torch.multistate.sampler import MultiStateSampler

    def make(matrix):
        def altered(self, windowed):
            u = matrix(self, windowed).clone()
            r, k = self.n_replicas - 1, self.n_states - 1
            u[0, 0], u[r, k] = u[r, k].clone(), u[0, 0].clone()
            return u
        return altered
    return patched(MultiStateSampler, "_energy_matrix", make)


def duplicated_state():
    from openmmtools_tpu_torch.multistate.replicaexchange import (
        ReplicaExchangeSampler,
    )

    def make(mix):
        def altered(self, *a, **kw):
            out = mix(self, *a, **kw)
            if out is None:
                return out
            states = out[0].clone()
            states[1] = states[0]
            return (states,) + tuple(out[1:])
        return altered
    return patched(ReplicaExchangeSampler, "_mix_kernel", make)


def no_constraints():
    """Only in a one-step run (the step the check follows): over many
    steps the unconstrained waters fly apart and the program stops."""
    skip = {"on": False}

    def make_run(run):
        def one(self, state, n_steps):
            skip["on"] = n_steps == 1
            try:
                return run(self, state, n_steps)
            finally:
                skip["on"] = False
        return one

    def make_constrain(fn):
        def constrain(self, x_new, x_old):
            return x_new if skip["on"] else fn(self, x_new, x_old)
        return constrain

    stack = contextlib.ExitStack()
    stack.enter_context(patched(_bound_class(), "run", make_run))
    stack.enter_context(patched(_bound_class(), "_constrain_positions",
                                make_constrain))
    return stack


def hot_state():
    """Every state the program builds carries 1.1 times its kT."""
    def make(with_forces):
        def hot(self, state):
            return with_forces(self, state.replace(kT=1.1 * state.kT))
        return hot
    return patched(_bound_class(), "_with_initial_forces", make)


def wrong_lambdas():
    """A batched step evaluates every replica at the first replica's
    global parameters; the state keeps its own."""
    def make(step):
        def first(self, state, **kw):
            params = state.global_params
            if state.positions.dim() != 3 or not params:
                return step(self, state, **kw)
            wrong = {k: v[:1].expand_as(v).clone() for k, v in params.items()}
            new = step(self, state.replace(global_params=wrong), **kw)
            return new.replace(global_params=params)
        return first
    return patched(_bound_class(), "step", make)


FAULTS = {"stuck": stuck, "half_batch": half_batch,
          "altered_forces": altered_forces, "altered_matrix": altered_matrix,
          "duplicated_state": duplicated_state,
          "no_constraints": no_constraints, "hot_state": hot_state,
          "wrong_lambdas": wrong_lambdas}
