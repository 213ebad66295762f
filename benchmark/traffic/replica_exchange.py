"""The ``replica_exchange`` driver: ``ReplicaExchangeSampler`` over the
configuration's lambda ladder, a closed loop of whole iterations (mixing,
propagation of every replica, the full energy matrix, which ends on the
host).

The traffic file gives the move (``LangevinSplittingDynamicsMove``: its
splitting, time step, collision rate and steps an iteration), the mixing
scheme, the FIRE iterations and warm-up iterations of set-up, and the
iterations of the traced spans.

The check adds to the shared numbers (:mod:`benchmark.check`):

* ``force_rel``: the worst replica's largest force component's error over
  its largest reference component, the reference at the replica's own
  state's lambdas; ``alch_force_rel`` the same over the alchemical atoms
  alone, where the lambdas act;
* ``matrix_kT``: the largest |u - u_ref| of the last iteration's reduced
  potentials, in kT, every replica at every state that carries weight
  (within ``check.WEIGHT_KT`` of its row's least, in the reference or in
  the program; further up a decoupled water's contact makes u huge and its
  float32 rounding large in kT, while its Boltzmann factor, under e^-100
  against the row's least, reaches no swap and no free energy);
* ``map_faults``: how far the replica-to-state map is from a permutation;
* ``counter_faults``: how many of the swap counters' invariants the window
  broke (symmetric, 0 <= accepted <= proposed, nothing proposed between a
  state and itself, something proposed).
"""
from __future__ import annotations

import numpy as np

from benchmark import check as checks
from benchmark.reference.energy import K_BOLTZMANN, Reference
from benchmark.workloads import host, step_marks

# each fault this kind of cell can have, and the number that catches it
FAULTS = {"stuck": "step_residual", "half_batch": "step_residual",
          "altered_forces": "force_rel", "wrong_lambdas": "alch_force_rel",
          "altered_matrix": "matrix_kT", "duplicated_state": "map_faults",
          "no_constraints": "constraint_rel", "hot_state": "thermostat_rel"}


class Driver:
    e2e = "iteration_s"

    def __init__(self, built, config, traffic, seed, device):
        self.built, self.config, self.traffic = built, config, traffic
        self.seed, self.device = seed, device
        self.dt = float(traffic["timestep_ps"])

    def ladder(self):
        """[(lambda_electrostatics, lambda_sterics)] of each state."""
        lad = self.config["lambda_ladder"]
        return list(zip(lad["lambda_electrostatics"], lad["lambda_sterics"]))

    def setup(self):
        from openmmtools_tpu_torch.alchemy import AlchemicalState
        from openmmtools_tpu_torch.mcmc import LangevinSplittingDynamicsMove
        from openmmtools_tpu_torch.multistate import ReplicaExchangeSampler
        from openmmtools_tpu_torch.states import (
            CompoundThermodynamicState,
            ThermodynamicState,
            create_thermodynamic_state_protocol,
        )

        t = self.traffic
        ts = self.built.testsystem
        ref = CompoundThermodynamicState(
            base_state=ThermodynamicState(
                system=ts.system,
                temperature=float(self.config["temperature_K"])),
            composable_states=(AlchemicalState(lambda_electrostatics=1.0,
                                               lambda_sterics=1.0),))
        lad = self.config["lambda_ladder"]
        self.states = create_thermodynamic_state_protocol(
            ref, {k: list(v) for k, v in lad.items()})
        self.move = LangevinSplittingDynamicsMove(
            timestep=self.dt, collision_rate=float(t["collision_rate_per_ps"]),
            n_steps=int(t["steps_per_iteration"]), splitting=t["splitting"])
        self.last_batch = None
        self.move._on_integration_end = self._keep_batch
        self.sampler = ReplicaExchangeSampler(
            mcmc_moves=self.move, number_of_iterations=1 << 40,
            online_analysis_interval=None,
            replica_mixing_scheme=t["mixing"], rng_seed=self.seed)
        self.sampler.create(self.states, ts.sampler_state())
        if self.sampler.propagation_route != "batched":
            raise RuntimeError("the replicas do not take the batched route")
        self.sampler.minimize(max_iterations=int(t["minimize_iterations"]))
        for _ in range(int(t["warmup_iterations"])):
            self.sampler.run(1)
        self.iterations_before = self.sampler.iteration
        self.counts_before = self._counts()

    def _keep_batch(self, final_state):
        self.last_batch = final_state

    def _counts(self):
        return (self.sampler._n_accepted.numpy().copy(),
                self.sampler._n_proposed.numpy().copy())

    def unit(self):
        self.sampler.run(1)
        return 1

    def metric(self, work, units, wall):
        """Seconds an iteration: the window's wall time over its whole
        iterations."""
        return wall / work

    def outputs(self):
        """The last iteration's energy matrix, the replica-to-state map, the
        window's swap counters, the replicas' final positions, velocities
        and forces, and one more step of the move's own bound integrator
        from the batch it finished."""
        sp = self.sampler
        acc1, prop1 = self._counts()
        acc0, prop0 = self.counts_before
        s = self.last_batch
        temperature = float(self.config["temperature_K"])
        out = dict(box_edge=float(host(s.box).reshape(-1, 3, 3)[0, 0, 0]),
                   u=sp.energies_last_iteration.astype(np.float64),
                   replica_states=sp.replica_states.astype(np.int64),
                   accepted=acc1 - acc0, proposed=prop1 - prop0,
                   iterations=sp.iteration - self.iterations_before,
                   ladder=self.ladder(),
                   x0=host(s.positions), v0=host(s.velocities),
                   f0=sum(host(f) for f in s.forces), dt=self.dt,
                   gamma=float(self.traffic["collision_rate_per_ps"]),
                   temperature=temperature,
                   beta=1.0 / (K_BOLTZMANN * temperature))
        bound = self.move._bound(self.states[0])
        s1 = bound.run(s, 1)
        out.update(x1=host(s1.positions), v1=host(s1.velocities))
        return out

    def trace_unit(self):
        self.sampler.run(1)
        return 1

    @property
    def evaluations_per_unit(self):
        """K2 evaluations an iteration needs of each replica: one a step
        and one at each state for the matrix."""
        return int(self.traffic["steps_per_iteration"]) + len(self.states)

    def span_marks(self):
        from openmmtools_tpu_torch.integrators.langevin import BoundIntegrator

        return {"propagation": (self.move, "apply_batch"),
                "energy matrix": (BoundIntegrator, "energies_batch")}

    def marks(self):
        return dict(step_marks(self.move._bound(self.states[0])),
                    mixing=(self.sampler, "_mix_kernel"),
                    **self.span_marks())

    def free(self):
        self.sampler = self.move = self.states = self.last_batch = None


def check(out, spec, device, program=None):
    """The numbers of a ``replica_exchange`` run; ``program`` (a Reference)
    takes the program's place for the energy matrix and the forces: the
    control."""
    ref = Reference(spec, device)
    ladder = out["ladder"]
    beta = out["beta"]
    states = out["replica_states"]
    x0 = out["x0"]
    box_edge = out["box_edge"]
    k = len(ladder)
    u = np.asarray(out["u"])[:, :k]
    alch = np.asarray(spec.alchemical, bool)

    def lambdas(r):
        return ladder[int(states[r])]

    def forces_at(r, x):
        return ref.energy_forces(x, box_edge, *lambdas(r))[1]

    worst = force = alch_force = 0.0
    f_ref0 = []
    for r in range(x0.shape[0]):
        u_ref = beta * np.asarray(ref.energies_over(x0[r], box_edge, ladder))
        if program is None:
            u_r, f_r = u[r], out["f0"][r]
        else:
            u_r = beta * np.asarray(program.energies_over(x0[r], box_edge,
                                                          ladder))
            f_r = program.energy_forces(x0[r], box_edge, *lambdas(r))[1]
        worst = max(worst, checks.matrix_row_error(u_r, u_ref))
        f_ref = forces_at(r, x0[r])
        f_ref0.append(f_ref)
        force = max(force, checks.force_error(f_r, f_ref))
        alch_force = max(alch_force, checks.force_error(f_r[alch],
                                                        f_ref[alch]))
    in_range = states[(states >= 0) & (states < k)]
    map_faults = (len(states) - len(np.unique(in_range))
                  + int(np.sum((states < 0) | (states >= k))))
    acc, prop = np.asarray(out["accepted"]), np.asarray(out["proposed"])
    counter_faults = (int(not np.array_equal(acc, acc.T))
                      + int(not np.array_equal(prop, prop.T))
                      + int(np.any(acc < 0) or np.any(acc > prop))
                      + int(np.any(np.diag(prop) != 0))
                      + int(prop.sum() <= 0))
    values = {"matrix_kT": worst, "force_rel": force,
              "alch_force_rel": alch_force, "map_faults": map_faults,
              "counter_faults": counter_faults,
              "constraint_rel": checks.constraints_of(out, spec)}
    values.update(checks.step_checks(out, spec, f_ref0, forces_at))
    return values
