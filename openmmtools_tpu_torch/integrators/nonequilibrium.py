"""Nonequilibrium (NCMC) Langevin integrators: protocol work and H steps
(counterpart of ``integrators/nonequilibrium.py``).

openmmtools' ``AlchemicalNonequilibriumLangevinIntegrator``: the ``H``
substep advances the master ``lambda`` = lambda_step / n_lambda_steps,
evaluates each alchemical function of lambda into its global parameter, and
accumulates ``protocol_work += U_new - U_old``; the step and lambda counters
reset the work and lambda at the start of each cycle.
``PeriodicNonequilibriumIntegrator`` drives lambda 0 -> 1 -> 0 with
equilibration dwells; ``ExternalPerturbationLangevinIntegrator`` measures the
work of parameters changed from outside, here the explicit
:meth:`BoundNonequilibriumIntegrator.perturb` transition.

The step and lambda counters are host integers (the port's ``step_count``
is one), so the schedule is host arithmetic and reads nothing back from the
card. Lambda itself and every parameter derived from it are device tensors
(``torch.full`` of the scheduled value, then the alchemical functions as
tensor expressions), which the sweep kernel's class scalars are computed
from on the device.

A batch of protocols (``initial_state_batch``) runs them all at the same
step of the same schedule, each with its own noise; ``protocol_work`` is
(B,).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from openmmtools_tpu_torch.integrators.langevin import (
    BoundIntegrator,
    IntegratorError,
    IntegratorState,
    LangevinIntegrator,
)
from openmmtools_tpu_torch.utils.math_eval import math_eval


class BoundNonequilibriumIntegrator(BoundIntegrator):
    """BoundIntegrator with H steps, per-cycle work/lambda reset and
    :meth:`perturb`."""

    def _lambda_at(self, lambda_step, like):
        """The scheduled lambda after ``lambda_step`` H steps, as a tensor
        of ``like``'s type and device: 0-d for positions ``like`` (N, 3),
        one entry a replica for a batch (B, N, 3), every protocol of a
        batch being at the same step of the same schedule."""
        value = self.integrator._schedule(lambda_step, max(1, self.n_H))
        return torch.full(tuple(like.shape[:-2]), value, dtype=like.dtype,
                          device=like.device)

    def _parameters_at(self, lam, like):
        """The alchemical functions evaluated at ``lam``, as tensors of
        ``lam``'s shape."""
        return {name: torch.as_tensor(math_eval(expr, {"lambda": lam}),
                                      dtype=like.dtype,
                                      device=like.device).expand(lam.shape)
                for name, expr in self.integrator.alchemical_functions.items()}

    def _pre_step(self, env):
        cycle = self.integrator._n_steps_per_cycle()
        if cycle <= 0:
            return
        # reset work and lambda at the start of each cycle
        if env.step_count % cycle == 0:
            zero = torch.zeros(tuple(env.x.shape[:-2]), dtype=env.x.dtype,
                               device=env.x.device)
            env.protocol_work = zero
            env.shadow_work = zero
            env.heat = zero
            env.lambda_step = 0
            # the alchemical functions go back to their lambda-0 values too,
            # or a wrap-around protocol would start from its end values and
            # charge no work at its first H; a schedule that ends where it
            # starts (Periodic's 0 -> 1 -> 0) needs nothing
            n_H = max(1, self.n_H)
            lam0 = self.integrator._schedule(0, n_H)
            lam_end = self.integrator._schedule(cycle * n_H, n_H)
            if self.integrator.alchemical_functions and lam_end != lam0:
                env.params = {**env.params, **self._parameters_at(
                    self._lambda_at(0, env.x), env.x)}
                self._invalidate(env)
        env.lambda_ = self._lambda_at(env.lambda_step, env.x)

    def _emit_H(self, env):
        u_old = self._total_potential(env)
        env.lambda_step = env.lambda_step + 1
        lam = self._lambda_at(env.lambda_step, env.x)
        env.params = {**env.params, **self._parameters_at(lam, env.x)}
        self._invalidate(env)
        u_new = self._total_potential(env)
        env.protocol_work = env.protocol_work + (u_new - u_old)
        env.lambda_ = lam

    # -- external perturbation work (ExternalPerturbationLangevinIntegrator)
    def perturb(self, state: IntegratorState, new_params: Dict
                ) -> IntegratorState:
        """Change the global parameters between steps, charging the energy
        difference at the current positions to ``protocol_work``.

        Both energies are evaluated here, by the same path (in sweep mode
        the sweep kernel at the state's sort; where the path's whole-state
        energies take the dense sum, that sum), so that the
        lambda-independent bulk cancels exactly; the cached potentials of
        the step program are not reused."""
        x = state.positions
        box = state.box if state.box is not None else self.system.default_box
        params = {k: torch.as_tensor(v, dtype=x.dtype, device=x.device)
                  for k, v in new_params.items()}
        path = self.force_path
        ctx = None if path.dense_sums else path.context(state)
        u_old = torch.zeros((), dtype=x.dtype, device=x.device)
        for u in path.evaluate_groups(x, box, state.global_params, ctx)[0]:
            u_old = u_old + u
        potentials, forces, ctx = path.evaluate_groups(x, box, params, ctx)
        u_new = sum(potentials[1:], potentials[0])
        state = path.store(state, ctx)
        return state.replace(
            global_params=params, forces=tuple(forces),
            potentials=tuple(potentials),
            protocol_work=state.protocol_work + (u_new - u_old))


class NonequilibriumLangevinIntegrator(LangevinIntegrator):
    """Langevin integrator tracking protocol work: through explicit
    :meth:`BoundNonequilibriumIntegrator.perturb` calls (external protocols)
    or through H substeps (the alchemical subclasses)."""

    _bound_class = BoundNonequilibriumIntegrator
    alchemical_functions: Dict[str, str] = {}

    def _schedule(self, lambda_step, n_H: int) -> float:
        return 0.0

    def _n_steps_per_cycle(self) -> int:
        return 0


# the same object: NonequilibriumLangevinIntegrator + bound.perturb()
ExternalPerturbationLangevinIntegrator = NonequilibriumLangevinIntegrator


def _f32(x):
    return np.float32(x)


class AlchemicalNonequilibriumLangevinIntegrator(
        NonequilibriumLangevinIntegrator):
    """NCMC switching integrator.

    alchemical_functions: global parameter name -> expression of ``lambda``
        (e.g. ``{'lambda_sterics': 'min(1, 2*lambda)'}``);
    splitting: default 'O { V R H R V } O' (openmmtools' default);
    n_steps_neq: integrator steps per switching protocol, so
        n_lambda_steps = n_steps_neq * (H count per step); 0 switches
        instantaneously (one step completes the protocol).
    """

    _default_splitting = "O { V R H R V } O"

    def __init__(self, alchemical_functions: Optional[Dict[str, str]] = None,
                 splitting: Optional[str] = None, n_steps_neq=100, **kwargs):
        super().__init__(splitting=splitting, **kwargs)
        self.alchemical_functions = dict(alchemical_functions or {})
        if n_steps_neq < 0:
            raise IntegratorError("n_steps_neq must be >= 0")
        self.n_steps_neq = n_steps_neq
        if "H" not in self.splitting.upper().split():
            raise IntegratorError("alchemical splitting must contain an H step")

    def _schedule(self, lambda_step, n_H: int) -> float:
        # float32 arithmetic, as the JAX package schedules
        n = max(1, self.n_steps_neq) * max(1, n_H)
        return float(np.clip(_f32(lambda_step) / _f32(n), 0.0, 1.0))

    def _n_steps_per_cycle(self) -> int:
        return max(1, self.n_steps_neq)

    def initial_params(self):
        """The global parameters' values at lambda = 0."""
        return {name: float(math_eval(expr, {"lambda": 0.0}))
                for name, expr in self.alchemical_functions.items()}


class PeriodicNonequilibriumIntegrator(
        AlchemicalNonequilibriumLangevinIntegrator):
    """Periodic 0 -> 1 -> 0 protocol with equilibration dwells.

    Cycle: n_steps_eq at lambda = 0, n_steps_neq ramping up, n_steps_eq at
    lambda = 1, n_steps_neq ramping down. In H-substep units s:
    lambda(s) = clip((s - Neq)/Nneq, 0, 1) - clip((s - 2 Neq - Nneq)/Nneq,
    0, 1).
    """

    def __init__(self, alchemical_functions=None, splitting=None,
                 n_steps_eq=1000, n_steps_neq=100, **kwargs):
        super().__init__(alchemical_functions=alchemical_functions,
                         splitting=splitting, n_steps_neq=n_steps_neq,
                         **kwargs)
        self.n_steps_eq = n_steps_eq

    def _schedule(self, lambda_step, n_H: int) -> float:
        n_eq = _f32(self.n_steps_eq * n_H)
        n_neq = _f32(max(1, self.n_steps_neq * n_H))
        s = _f32(lambda_step)
        up = np.clip((s - n_eq) / n_neq, 0.0, 1.0)
        down = np.clip((s - (_f32(2.0) * n_eq + n_neq)) / n_neq, 0.0, 1.0)
        return float(_f32(up - down))

    def _n_steps_per_cycle(self) -> int:
        return 2 * self.n_steps_eq + 2 * self.n_steps_neq
