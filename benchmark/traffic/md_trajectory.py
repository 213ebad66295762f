"""The ``md_trajectory`` driver: one NVT trajectory through the program's
single-chain path, ``MCMCSampler`` with a ``LangevinDynamicsMove`` ("V R O
R V"), a closed loop of whole iterations. An iteration is one
``sampler.run(1)``: the move's initial forces, its steps, and the move's
host read of the NaN flag, where it ends.

The traffic file gives the move's time step, collision rate and steps an
iteration, the FIRE iterations and warm-up iterations of set-up, and the
iterations of the traced spans. On the card the move's integrator takes
sweep mode by itself; on the CPU (the tests' small runs) the driver sets
it to ``sweep="force"``, so that the same program runs with the kernels'
plain versions. The driver raises where the bound integrator is not in
sweep mode.

The check reads the timed window's last iteration, against the float64
reference and against the configuration:

* ``energy_rel``: |U - U_ref| / |U_ref| of the program's potential energy
  at the iteration's final positions;
* ``force_rel``: the largest force component's error there over the
  largest reference component;
* ``window_chain``: the largest change of any position (nm) or velocity
  (nm/ps) component between the iteration before's final state and this
  iteration's starting state; 0 where the sampler carries its state;
* ``window_still``: how many times more a free particle of a water's mass
  under the same thermostat would move over the iteration than the
  waters' centres of mass moved, as a ratio of root mean square
  displacements: ``sqrt(sum <dX^2>_free / sum |dX|^2)`` over the
  molecules, with ``<dX^2>_free = 6 kT / M (gamma t - 1 + exp(-gamma t)) /
  gamma^2`` and ``t`` the iteration's steps times the time step. Caged
  liquid water reads a few; a window that does not advance reads infinity
  and one that advances a single step of 250 reads about 230.

It then follows ``CHECK_STEPS`` more steps of the move's own bound
integrator from the iteration's final state, each one eager (the step
program itself, which a replayed step graph repeats to the bit), and reads
the shared numbers (:mod:`benchmark.check`) over them: ``constraint_rel``
at every configuration, the iteration's final one included,
``step_residual`` of the worst step, and ``thermostat_rel`` over the kicks
of every step pooled. Eager, the faults of :mod:`benchmark.faults` that
patch the step program's Python reach these steps on the card too.
"""
from __future__ import annotations

import numpy as np

from benchmark import check as checks
from benchmark.reference.energy import K_BOLTZMANN, Reference
from benchmark.workloads import host, step_marks

# steps the check follows from the window's final state: one step of one
# trajectory holds 3 kicks a molecule, whose mean square has a standard
# deviation of sqrt(2 / (3 n_molecules)) (0.056 at 216 waters, 0.0091 at
# 8,000), so the thermostat's number pools 16 steps' kicks
CHECK_STEPS = 16

# each fault this kind of cell can have, and the number that catches it
FAULTS = {"stuck": "step_residual", "altered_forces": "force_rel",
          "no_constraints": "constraint_rel", "hot_state": "thermostat_rel"}


class Driver:
    e2e = "iteration_s"

    def __init__(self, built, config, traffic, seed, device):
        self.built, self.config, self.traffic = built, config, traffic
        self.seed, self.device = seed, device
        self.dt = float(traffic["timestep_ps"])

    def setup(self):
        import torch

        from openmmtools_tpu_torch.mcmc import (
            LangevinDynamicsMove,
            MCMCSampler,
        )
        from openmmtools_tpu_torch.states import ThermodynamicState

        t = self.traffic
        ts = self.built.testsystem
        self.state = ThermodynamicState(
            system=ts.system, temperature=float(self.config["temperature_K"]))
        self.move = LangevinDynamicsMove(
            timestep=self.dt, collision_rate=float(t["collision_rate_per_ps"]),
            n_steps=int(t["steps_per_iteration"]), seed=self.seed)
        if torch.device(self.device).type != "cuda":
            self.move._get_integrator(self.state).sweep = "force"
        self.last_state = self.previous_state = self.window_start = None
        self.move._on_integration_end = self._keep_state
        if not self.move._bound(self.state).sweep_mode:
            raise RuntimeError("the move's bound integrator is not in sweep "
                               "mode")
        self.sampler = MCMCSampler(self.state, ts.sampler_state(), self.move)
        self.sampler.minimize(max_iterations=int(t["minimize_iterations"]))
        for _ in range(int(t["warmup_iterations"])):
            self.sampler.run(1)

    def _keep_state(self, final_state):
        self.previous_state, self.last_state = self.last_state, final_state

    def unit(self):
        self.window_start = self.sampler.sampler_state
        self.sampler.run(1)
        return 1

    def metric(self, work, units, wall):
        """Seconds an iteration: the window's wall time over its whole
        iterations."""
        return wall / work

    def outputs(self):
        """The last iteration's final positions, velocities and forces and
        the program's potential energy there; its starting positions and
        velocities (``xw``, ``vw``) and the iteration before's final ones
        (``xp``, ``vp``); and the positions and velocities of
        ``CHECK_STEPS`` more steps of the move's own bound integrator from
        the final state, one eager ``run`` a step (``xs``, ``vs``: the
        final state's first)."""
        s, start, before = self.last_state, self.window_start, \
            self.previous_state
        temperature = float(self.config["temperature_K"])
        out = dict(box_edge=float(host(s.box).reshape(3, 3)[0, 0]),
                   x0=host(s.positions), v0=host(s.velocities),
                   f0=sum(host(f) for f in s.forces),
                   u0=float(sum(float(u) for u in s.potentials)),
                   # a start without velocities (to be drawn afresh)
                   # carries no state over: infinitely far from it
                   xw=host(start.positions),
                   vw=(np.full(s.velocities.shape, np.inf)
                       if start.velocities is None
                       else host(start.velocities)),
                   xp=host(before.positions), vp=host(before.velocities),
                   n_steps=int(self.traffic["steps_per_iteration"]),
                   dt=self.dt,
                   gamma=float(self.traffic["collision_rate_per_ps"]),
                   temperature=temperature,
                   beta=1.0 / (K_BOLTZMANN * temperature))
        bound = self.move._bound(self.state)
        xs, vs = [out["x0"]], [out["v0"]]
        graphed, bound._graph_program = bound._graph_program, False
        try:
            for _ in range(CHECK_STEPS):
                s = bound.run(s, 1)
                xs.append(host(s.positions))
                vs.append(host(s.velocities))
        finally:
            bound._graph_program = graphed
        out.update(xs=np.stack(xs), vs=np.stack(vs))
        return out

    trace_unit = unit

    @property
    def evaluations_per_unit(self):
        """K2 evaluations an iteration makes: the move's initial forces and
        one a step."""
        return int(self.traffic["steps_per_iteration"]) + 1

    def span_marks(self):
        return {"propagation": (self.move, "apply")}

    def marks(self):
        return dict(step_marks(self.move._bound(self.state)),
                    **self.span_marks())

    def free(self):
        self.sampler = self.move = self.state = None
        self.last_state = self.previous_state = self.window_start = None


def check(out, spec, device, program=None):
    """The numbers of an ``md_trajectory`` run; ``program`` (a Reference)
    takes the program's place for the energy and the forces: the
    control."""
    ref = Reference(spec, device)
    box_edge = out["box_edge"]
    x0 = out["x0"]
    u_ref, f_ref = ref.energy_forces(x0, box_edge)
    if program is None:
        u, f = out["u0"], out["f0"]
    else:
        u, f = program.energy_forces(x0, box_edge)
    xs, vs = out["xs"], out["vs"]
    # the reference forces at each configuration of the check's steps
    f_refs = [f_ref] + [ref.energy_forces(x, box_edge)[1] for x in xs[1:]]
    steps = dict(out, x0=xs[:-1], v0=vs[:-1], x1=xs[1:], v1=vs[1:])
    values = {"energy_rel": abs(u - u_ref) / abs(u_ref),
              "force_rel": checks.force_error(f, f_ref),
              "constraint_rel": checks.constraint_rel(xs, spec, box_edge)}
    values.update(checks.step_checks(steps, spec, f_refs[:-1],
                                     lambda i, x: f_refs[i + 1]))
    values.update(window_numbers(out, spec))
    return values


def window_numbers(out, spec):
    """``window_chain`` and ``window_still`` of the window's last iteration
    (the module's docstring); kT, gamma and the time step are the
    configuration's and the traffic's, never the program's."""
    chain = max(float(np.max(np.abs(out["xw"] - out["xp"]))),
                float(np.max(np.abs(out["vw"] - out["vp"]))))
    box_edge = out["box_edge"]
    d = out["x0"] - out["xw"]
    d = d - box_edge * np.round(d / box_edge)
    m = spec.masses[:, None]
    n_mol = int(spec.molecule.max()) + 1
    mass = np.zeros(n_mol)
    np.add.at(mass, spec.molecule, spec.masses)
    dX = np.zeros((n_mol, 3))
    np.add.at(dX, spec.molecule, m * d)
    dX /= mass[:, None]
    g, t = out["gamma"], out["n_steps"] * out["dt"]
    free = (6.0 * K_BOLTZMANN * out["temperature"] / mass
            * (g * t - 1.0 + np.exp(-g * t)) / g ** 2)
    moved = float(np.sum(dX * dX))
    still = (np.inf if moved == 0.0
             else float(np.sqrt(np.sum(free) / moved)))
    return {"window_chain": chain, "window_still": still}
