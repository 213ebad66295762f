"""What the drivers share.

A traffic file (``traffic/<name>.json``) holds parameters only, and names
its driver: ``"driver": "<kind>"`` is the module ``traffic/<kind>.py``,
found by name, so that a new kind of work is a new file. A driver module
holds:

* ``Driver(built, config, traffic, seed, device)``: it builds its run in
  ``setup()`` (everything the window will use, warmed once), does one unit
  of work in ``unit()`` and returns the work it did, turns the window's
  (work, units, wall seconds) into its end-to-end metric ``e2e`` in
  ``metric()``, and after the window hands the check its outputs
  (``outputs()``, on the host); for the traced run ``trace_unit()``,
  ``marks()`` and ``span_marks()`` (the program's functions to mark, as
  ``label: (object, attribute)``) and ``evaluations_per_unit``; ``free()``
  drops the program's state;
* ``check(outputs, spec, device, program=None)``: the numbers that decide
  ``correct`` (:mod:`benchmark.check` has the shared ones), with
  ``program``, a Reference, in the program's place for the control;
* ``FAULTS``: each fault of :mod:`benchmark.faults` that such a cell can
  have, and the number that catches it.

Seeds: the seed draws the initial velocities and every random number of
the run; the configuration's atoms and sizes are the same for every seed.
"""
from __future__ import annotations

import time

import torch


def host(t):
    """A tensor on the host in float64, as numpy."""
    return t.detach().to(torch.float64).cpu().numpy()


def step_marks(bound):
    """The step program's parts as (object, attribute) to mark: K2, the
    constraints on positions and on velocities, the Ewald structure
    factors forward and backward, and the rest of the remainder."""
    import openmmtools_tpu_torch.integrators.langevin as lg
    from openmmtools_tpu_torch.ops import pme

    return {"K2": (getattr(bound, "_sweep_kernel", None), "evaluate"),
            "constraints, positions": (bound, "_constrain_positions"),
            "constraints, velocities": (bound, "_constrain_velocities"),
            "PME, forward": (pme, "_sf_forward_real"),
            "PME, backward": (pme, "_sf_real_backward"),
            "remainder": (lg, "value_and_grad")}


def timed_window(drv, seconds, device):
    """Whole units of work until ``seconds`` have passed: (work, units,
    wall). Each unit ends in a host read, so the clock cannot stop before
    the device has."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    work = units = 0
    ends = []
    while True:
        work += drv.unit()
        units += 1
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    drv.unit_seconds = [b - a for a, b in zip([0.0] + ends, ends)]
    return work, units, ends[-1]
