"""The numbers that decide ``correct`` and that every driver shares.

After the window has closed and the program's state is freed, the plain
reference (:mod:`benchmark.reference`, float64) works out again what the
timed path produced, at the positions the path produced; the driver's
``check`` (``traffic/<kind>.py``) gathers its numbers, and each is held to
its limit in ``limits/<cell>.json``. A number is a worst case or a
whole-sample statistic, never an average that one bad answer could hide
in.

* ``constraint_rel``: the largest |r - d| / d over the constraints at the
  window's final positions and one step later, d from the configuration.
* ``step_residual``: the reference follows the program's last step. For
  every molecule the constraint forces are internal, so the Langevin
  splitting "V R O R V" moves its centre of mass by exactly
  ``dX = dt/2 (P1 + P2) / M`` with ``P1 = P0 + dt/2 F(x0)`` and ``P2 = P3 -
  dt/2 F(x1)`` whatever the noise; the number is the root mean square of
  ``dX`` minus that, over the root mean square of ``dt/2 (P1 + P2) / M``
  (F from the reference), of the worst trajectory. A step that returns its
  state unchanged reads 1.
* ``thermostat_rel``: the O substep's kick to each molecule's momentum,
  ``(P2 - a P1) / (b sqrt(kT M))`` with ``a = exp(-gamma dt)``, ``b =
  sqrt(1 - a^2)`` and kT from the configuration's temperature, is a
  standard normal; the number is |mean square - 1| over every molecule,
  axis and trajectory.
* ``force_rel`` (the largest force component's error over the largest
  reference component, :func:`force_error`).
"""
from __future__ import annotations

import math

import numpy as np

from benchmark.reference.energy import K_BOLTZMANN


WEIGHT_KT = 100.0


def _unwrap(x1, x0, box_edge):
    d = x1 - x0
    return x0 + d - box_edge * np.round(d / box_edge)


def constraint_rel(x, spec, box_edge):
    c = spec.constraints
    d = x[..., c[:, 0], :] - x[..., c[:, 1], :]
    d = d - box_edge * np.round(d / box_edge)
    r = np.sqrt(np.sum(d * d, -1))
    return float(np.max(np.abs(r - spec.constraint_distance)
                        / spec.constraint_distance))


def constraints_of(out, spec):
    return max(constraint_rel(out[k], spec, out["box_edge"])
               for k in ("x0", "x1"))


def step_numbers(x0, v0, x1, v1, f0, f1, spec, box_edge, dt, kT, gamma):
    """(step_residual, the O substep's kicks (n_mol, 3)) of one step of one
    trajectory, float64 arrays (N, 3); f0, f1 the reference forces."""
    mol = spec.molecule
    n_mol = int(mol.max()) + 1
    m = spec.masses[:, None]

    def per_mol(a):
        out = np.zeros((n_mol, 3))
        np.add.at(out, mol, a)
        return out

    M = per_mol(np.repeat(m, 3, 1))
    dX = per_mol(m * (_unwrap(x1, x0, box_edge) - x0)) / M
    P1 = per_mol(m * v0 + 0.5 * dt * f0)
    P2 = per_mol(m * v1 - 0.5 * dt * f1)
    drift = 0.5 * dt * (P1 + P2) / M
    resid = math.sqrt(np.mean((dX - drift) ** 2) / np.mean(drift ** 2))
    a = math.exp(-gamma * dt)
    b = math.sqrt(1.0 - a * a)
    return resid, (P2 - a * P1) / (b * np.sqrt(kT * M))


def step_checks(out, spec, f0_ref, forces_at):
    """step_residual (the worst trajectory's) and thermostat_rel (every
    trajectory's kicks pooled) over the trajectories of ``out`` (one, or a
    replica axis): ``f0_ref[i]`` is trajectory i's reference forces at its
    final positions, ``forces_at(i, x)`` gives them at x. kT is the
    configuration's, never the program's."""
    x0, v0, x1, v1 = (np.asarray(out[k]) for k in ("x0", "v0", "x1", "v1"))
    if x0.ndim == 2:
        x0, v0, x1, v1 = x0[None], v0[None], x1[None], v1[None]
    kT = K_BOLTZMANN * out["temperature"]
    worst, kicks = 0.0, []
    for i in range(x0.shape[0]):
        res, xi = step_numbers(x0[i], v0[i], x1[i], v1[i], f0_ref[i],
                               forces_at(i, x1[i]), spec, out["box_edge"],
                               out["dt"], kT, out["gamma"])
        worst = max(worst, res)
        kicks.append(xi)
    xi = np.concatenate(kicks)
    return {"step_residual": worst,
            "thermostat_rel": abs(float(np.mean(xi * xi)) - 1.0)}


def force_error(f, f_ref):
    """The largest force component's error over the largest reference
    component."""
    return float(np.max(np.abs(f - f_ref)) / np.max(np.abs(f_ref)))


def matrix_row_error(u, u_ref):
    """The largest |u - u_ref| (kT) of one row over the states that carry
    weight in either."""
    seen = (u_ref - u_ref.min() < WEIGHT_KT) | (u - u.min() < WEIGHT_KT)
    return float(np.max(np.abs(u - u_ref)[seen]))


def verdict(values, limits):
    """(correct, [(name, value, limit)]): every number at or under its
    limit; a number without a limit, or a limit without a number, fails."""
    rows = []
    ok = set(values) == set(limits)
    for name in sorted(set(values) | set(limits)):
        v, lim = values.get(name), limits.get(name)
        rows.append((name, v, lim))
        ok = ok and v is not None and lim is not None and np.isfinite(v) \
            and v <= lim
    return bool(ok), rows
