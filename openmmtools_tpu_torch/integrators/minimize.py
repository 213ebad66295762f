"""Energy minimizers (counterpart of ``integrators/minimize.py``).

FIRE, adaptive-step gradient descent and L-BFGS as host loops over tensor
steps, and :func:`minimize`, the policy ``MCMCSampler.minimize`` runs:
FIRE, then L-BFGS, then gradient descent while the result is not finite;
SHAKE onto the constraints before the acceptance check; never a state worse
than the input. ``FIREMinimizationIntegrator`` and
``GradientDescentMinimizationIntegrator`` carry the openmmtools names.

Each minimizer takes ``energy_forces(x) -> (U, F)``; without it, the dense
energy and its autograd forces, which raise on the card from
``DENSE_LIMIT`` atoms up. :func:`minimize` takes ``energy_forces`` and
FIRE's constraint projection from the bound integrator that the context
cache holds for the state (``cache.py``), and so does its acceptance
check's energy: sweep mode and the sweep kernel with SETTLE on a water box
on the card. The JAX package runs them all on the dense energy and leaves
FIRE's steps unprojected.
"""
from __future__ import annotations

import torch

from openmmtools_tpu_torch.states import SamplerState, ThermodynamicState
from openmmtools_tpu_torch.system import (
    System,
    make_energy_fn,
    refuse_dense,
    value_and_grad,
)


def _dense_energy_forces(system, box, params, x, what):
    """``energy_forces`` by the dense energy and autograd; refused on the
    card from ``DENSE_LIMIT`` atoms up."""
    refuse_dense(system, x, what)
    u_fn = make_energy_fn(system)

    def energy_forces(xx):
        u, g = value_and_grad(lambda y: u_fn(y, box, params), xx)
        return u, -g

    return energy_forces


def fire_minimize(system: System, x, box=None, params=None, *,
                  timestep=1e-3, max_steps=500, alpha0=0.1, f_inc=1.1,
                  f_dec=0.5, alpha_shrink=0.99, n_min=5, dt_max_factor=10.0,
                  energy_forces=None, constrain=None):
    """FIRE (Fast Inertial Relaxation Engine) minimization.

    The scheme and defaults of openmmtools' FIREMinimizationIntegrator:
    velocity mixing v = (1-a) v + a |v| F/|F|, accelerate dt after n_min
    consecutive downhill steps, halve dt and zero velocities on uphill steps.
    ``energy_forces(x) -> (U, F)`` replaces the dense energy and its
    autograd forces (a bound integrator's ``energy_forces_at``: sweep mode
    on a large system); ``constrain(x_new, x_old)`` projects each step's
    positions onto the constraints, the velocities following the projected
    step. Returns (x_min, U_min).
    """
    if energy_forces is None:
        energy_forces = _dense_energy_forces(system, box, params, x,
                                             "fire_minimize")
    masses = torch.clamp(system.masses, min=1e-30)[:, None]
    dt_max = dt_max_factor * timestep

    x = x.detach()
    v = torch.zeros_like(x)
    dt = torch.as_tensor(timestep, dtype=x.dtype, device=x.device)
    alpha = torch.as_tensor(alpha0, dtype=x.dtype, device=x.device)
    n_up = torch.zeros((), dtype=torch.int64, device=x.device)
    for _ in range(max_steps):
        _, f = energy_forces(x)
        power = torch.sum(f * v)
        f_norm = torch.sqrt(torch.sum(f * f) + 1e-30)
        v_norm = torch.sqrt(torch.sum(v * v))
        v_mixed = (1.0 - alpha) * v + alpha * v_norm * f / f_norm
        uphill = power < 0.0
        v_new = torch.where(uphill, torch.zeros_like(v), v_mixed)
        n_up = torch.where(uphill, 0, n_up + 1)
        grow = (~uphill) & (n_up > n_min)
        dt = torch.where(grow, torch.clamp(dt * f_inc, max=dt_max),
                         torch.where(uphill, dt * f_dec, dt))
        alpha = torch.where(grow, alpha * alpha_shrink,
                            torch.where(uphill, alpha0, alpha))
        # MD step (velocity Verlet style kick-drift)
        v_next = v_new + dt * f / masses
        x_next = x + dt * v_next
        if constrain is not None:
            x_next = constrain(x_next, x)
            v_next = (x_next - x) / dt
        # guard against blowups: keep the previous iterate
        finite = torch.all(torch.isfinite(x_next))
        x = torch.where(finite, x_next, x)
        v = torch.where(finite, v_next, torch.zeros_like(v))
    return x, energy_forces(x)[0].detach()


def gradient_descent_minimize(system: System, x, box=None, params=None, *,
                              initial_step=1e-4, max_steps=200,
                              energy_forces=None):
    """Adaptive-step gradient descent (openmmtools'
    GradientDescentMinimizationIntegrator): x -= gamma grad/|grad|max,
    kept if the energy drops (gamma grows by 1.2), else gamma halves.
    ``energy_forces`` as in :func:`fire_minimize`. Returns (x_min,
    U_min)."""
    if energy_forces is None:
        energy_forces = _dense_energy_forces(
            system, box, params, x, "gradient_descent_minimize")

    def energy(xx):
        with torch.no_grad():
            return energy_forces(xx)[0]

    x = x.detach()
    u = energy(x)
    gamma = torch.as_tensor(initial_step, dtype=x.dtype, device=x.device)
    for _ in range(max_steps):
        g = -energy_forces(x)[1]
        gmax = torch.clamp(torch.max(torch.abs(g)), min=1e-12)
        x_try = x - gamma * g / gmax
        u_try = energy(x_try)
        better = u_try < u
        x = torch.where(better, x_try, x)
        u = torch.where(better, u_try, u)
        gamma = torch.where(better, gamma * 1.2, gamma * 0.5)
    return x, u


def lbfgs_minimize(system: System, x, box=None, params=None, *,
                   max_steps=200, history=10, tolerance=10.0,
                   max_backtracks=25, energy_forces=None):
    """L-BFGS with the two-loop recursion and bounded Armijo backtracking,
    the analog of OpenMM's LocalEnergyMinimizer. Each iteration caps the
    largest per-atom displacement at 0.05 nm. It always runs ``max_steps``
    iterations, as the JAX package's scan does; ``tolerance`` (RMS force,
    kJ/mol/nm) is accepted for the same signature and, as there, stops
    nothing. ``energy_forces`` as in :func:`fire_minimize`. Returns
    (x_min, U_min)."""
    if energy_forces is None:
        energy_forces = _dense_energy_forces(system, box, params, x,
                                             "lbfgs_minimize")
    m = int(history)
    shape = x.shape
    n = x.numel()
    dtype, device = x.dtype, x.device

    def flat_vg(xf):
        u, f = energy_forces(xf.reshape(shape))
        return u, -f.reshape(-1)

    def energy_at(xf):
        with torch.no_grad():
            return energy_forces(xf.reshape(shape))[0]

    xf = x.detach().reshape(-1)
    u, g = flat_vg(xf)
    S = torch.zeros((m, n), dtype=dtype, device=device)
    Y = torch.zeros((m, n), dtype=dtype, device=device)
    rho = torch.zeros((m,), dtype=dtype, device=device)
    valid = torch.zeros((m,), dtype=torch.bool, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    for _ in range(max_steps):
        # two-loop recursion: rows are oldest..newest
        q = g
        alphas = [None] * m
        for i in reversed(range(m)):
            a = torch.where(valid[i], rho[i] * torch.dot(S[i], q), zero)
            q = q - a * Y[i]
            alphas[i] = a
        sy = torch.dot(S[m - 1], Y[m - 1])
        yy = torch.dot(Y[m - 1], Y[m - 1])
        gamma = torch.where(valid[m - 1], sy / torch.clamp(yy, min=1e-30),
                            torch.ones_like(sy))
        r = gamma * q
        for i in range(m):
            b = torch.where(valid[i], rho[i] * torch.dot(Y[i], r), zero)
            r = r + S[i] * (alphas[i] - b)
        d = -r
        g_dot_d = torch.dot(g, d)
        # not a descent direction: fall back to -g
        bad = g_dot_d >= 0.0
        d = torch.where(bad, -g, d)
        g_dot_d = torch.where(bad, -torch.dot(g, g), g_dot_d)
        # trust region: at most 0.05 nm per atom per iteration
        max_disp = torch.max(torch.sqrt(torch.sum(d.reshape(shape) ** 2,
                                                  dim=-1)))
        cap = torch.clamp(0.05 / torch.clamp(max_disp, min=1e-12), max=1.0)
        d = d * cap
        g_dot_d = g_dot_d * cap

        # Armijo backtracking, bounded
        t = torch.ones((), dtype=dtype, device=device)
        u_try = energy_at(xf + t * d)
        it = 0
        while (it < max_backtracks
               and bool(u_try > u + 1e-4 * t * g_dot_d)):
            t = t * 0.5
            u_try = energy_at(xf + t * d)
            it += 1
        accept = torch.isfinite(u_try) & (u_try <= u)
        x_new = torch.where(accept, xf + t * d, xf)
        _, g_new = flat_vg(x_new)
        u = torch.where(accept, u_try, u)

        s_vec = x_new - xf
        y_vec = g_new - g
        sy_new = torch.dot(s_vec, y_vec)
        if bool(accept & (sy_new > 1e-10)):
            S = torch.cat([S[1:], s_vec[None]])
            Y = torch.cat([Y[1:], y_vec[None]])
            rho = torch.cat([rho[1:], (1.0 / torch.clamp(sy_new,
                                                         min=1e-30))[None]])
            valid = torch.cat([valid[1:], valid.new_ones((1,))])
        xf, g = x_new, g_new
    return xf.reshape(shape), u


def minimize(thermodynamic_state: ThermodynamicState,
             sampler_state: SamplerState, tolerance: float = 1.0,
             max_iterations: int = 500, context_cache=None) -> SamplerState:
    """Minimize a sampler state under a thermodynamic state (the
    ``MCMCSampler.minimize`` / LocalEnergyMinimizer analog).

    FIRE; L-BFGS from the input if FIRE's energy is not finite; gradient
    descent from the input if that one's is not either. Every energy and
    force comes from the bound integrator that ``context_cache`` (default:
    the global cache) holds for the state (``energy_forces_at``), and FIRE
    projects each step by its constraint solvers. On a constrained system
    the result is projected by SHAKE before the acceptance check, and a
    result whose energy is above the input's (or not finite) returns the
    input. ``tolerance`` is accepted for the same signature; each minimizer
    runs ``max_iterations`` steps.
    """
    if context_cache is None:
        from openmmtools_tpu_torch.cache import global_context_cache

        context_cache = global_context_cache
    system = thermodynamic_state.system
    box = sampler_state.box_vectors
    if box is None:
        box = system.default_box
    params = thermodynamic_state.global_params
    x0 = sampler_state.positions
    bound, _ = context_cache.get_context(thermodynamic_state)

    def energy_forces(xx):
        return bound.energy_forces_at(xx, box, params)

    def energy(xx):
        with torch.no_grad():
            return bound.energies_at(xx, box, [params])[0]

    solver = bound.constraint_solver
    x_min, u_min = fire_minimize(
        system, x0, box, params, max_steps=max_iterations,
        energy_forces=energy_forces,
        constrain=None if solver is None else solver.positions)
    if not bool(torch.isfinite(u_min)):
        x_min, u_min = lbfgs_minimize(system, x0, box, params,
                                      max_steps=max_iterations,
                                      energy_forces=energy_forces)
    if not bool(torch.isfinite(u_min)):
        x_min, u_min = gradient_descent_minimize(system, x0, box, params,
                                                 max_steps=max_iterations,
                                                 energy_forces=energy_forces)
    # the projection comes before the acceptance check: the unconstrained
    # minimum of a rigid system can lie far off its constraint manifold,
    # and projecting it can raise the energy above the input's
    if solver is not None:
        from openmmtools_tpu_torch.ops.constraints import shake_positions

        x_min = shake_positions(x_min, x_min, system.constraints,
                                system.masses)
        u_min = energy(x_min)
    u0 = energy(x0)
    if bool(u_min > u0) or not bool(torch.isfinite(u_min)):
        return sampler_state
    return sampler_state.replace(positions=x_min)


class FIREMinimizationIntegrator:
    """openmmtools' FIREMinimizationIntegrator by name: ``minimize(system,
    x, ...)`` through :func:`fire_minimize`."""

    def __init__(self, timestep=1e-3, alpha=0.1, n_min=5, **kwargs):
        self.timestep = timestep
        self.alpha = alpha
        self.n_min = n_min

    def minimize(self, system, x, box=None, params=None, max_steps=500):
        return fire_minimize(system, x, box, params, timestep=self.timestep,
                             alpha0=self.alpha, n_min=self.n_min,
                             max_steps=max_steps)


class GradientDescentMinimizationIntegrator:
    """openmmtools' GradientDescentMinimizationIntegrator by name:
    ``minimize(system, x, ...)`` through :func:`gradient_descent_minimize`."""

    def __init__(self, initial_step_size=1e-4):
        self.initial_step_size = initial_step_size

    def minimize(self, system, x, box=None, params=None, max_steps=200):
        return gradient_descent_minimize(
            system, x, box, params, initial_step=self.initial_step_size,
            max_steps=max_steps)
