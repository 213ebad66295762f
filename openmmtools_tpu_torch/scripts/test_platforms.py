"""Every-system cross-device / cross-precision parity sweep (counterpart of
``scripts/test_platforms.py``).

The reference's ``test-openmm-platforms`` console script computes the
potential energy and forces of every test system on every installed OpenMM
platform and flags deviations beyond 0.06 kcal/mol, serializing failures for
reproduction. Here the "platforms" are the port's compute configurations,
named through :mod:`openmmtools_tpu_torch.utils.platforms`:

  * cpu/f64  - the reference configuration (error floor)
  * cpu/f32  - the production dtype on the host
  * cuda/f32 - the production configuration, when a card is present
  * kernel   - the bound integrator's kernel path (K1's fused chunk or K2's
               sweep) against the dense float32 sum of the same system on
               the same device; each check reads the kernel wrappers'
               launch counters, and on the card a check in which one of
               the path's kernels launched nothing fails (it compared
               nothing): K1's ``lj_forces`` (the initial state) and
               ``lj_chunk`` (a 0-step run), K2's bound and force kernels. On the CPU no kernel
               path engages by default, as in the JAX package's CPU sweep.

Energies are compared within --tolerance (default 0.06 kcal/mol, scaled up
for |U| large enough that float32 representation alone exceeds it); forces
within a relative tolerance. Failures are serialized to --failure-dir as
JSON + NPZ repro files.

A system whose constructor needs arguments (a parameter without a default:
the JAX sweep's ``TypeError``) or data that is not in the checkout
(``FileNotFoundError``) is skipped and named; any other constructor error,
and an unknown name, is a failure (the JAX sweep skips every constructor
error, which on the card would hide a fault of the port). On the card a
system of ``DENSE_LIMIT`` atoms or more takes its cuda/f32 energy and forces
through a bound integrator's ``energy_forces_at`` (the dense sum is refused
there).

Run on the CPU: ``python -m openmmtools_tpu_torch.scripts.test_platforms
--device cpu --no-kernels``; on a machine with a card, with no arguments.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ENERGY_TOLERANCE_KJ = 0.06 * 4.184  # reference: 0.06 kcal/mol
FORCE_RTOL = 5e-3

# the giant systems, whose dense float64 evaluations cost minutes each on
# the host (the JAX package's list)
_SLOW = {"DHFRExplicit", "DNADodecamerExplicit", "LysozymeImplicit",
         "HostGuestExplicit", "GiantWaterBox", "GiantFlexibleWaterBox",
         "GiantFlexibleDischargedWaterBox"}


def platforms(device=None):
    """The platform names of a sweep on ``device`` ("cpu", "cuda", or None
    for the fastest available): cpu/f32, and cuda/f32 when the sweep runs
    on the card."""
    from openmmtools_tpu_torch.utils.platforms import get_fastest_platform

    if device is None:
        device = get_fastest_platform().lower()
    return ["cpu/f32"] + (["cuda/f32"] if device == "cuda" else [])


def _catalog_class(name):
    import openmmtools_tpu_torch.models as models

    return getattr(models, name, None)


def _needs_arguments(cls) -> bool:
    """Whether the constructor has a parameter without a default (the JAX
    sweep's ``TypeError`` skip, decided before the call, so that a
    ``TypeError`` raised inside a constructor is a failure)."""
    import inspect

    return any(p.default is inspect.Parameter.empty
               and p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD,
                              p.KEYWORD_ONLY)
               for p in inspect.signature(cls).parameters.values())


def _evaluate(system, dtype, device, positions):
    """(U, F, via) of ``system`` at ``positions`` on ``device`` in
    ``dtype``: the dense energy and its autograd forces, or on the card
    from ``DENSE_LIMIT`` atoms up a bound integrator's ``energy_forces_at``
    (``via`` names which)."""
    import torch

    from openmmtools_tpu_torch.system import (
        DENSE_LIMIT,
        make_energy_fn,
        value_and_grad,
    )

    system = system.to(device=device, dtype=dtype)
    x = positions.to(device=device, dtype=dtype)
    box = system.default_box
    if torch.device(device).type == "cuda" and \
            system.n_particles >= DENSE_LIMIT:
        from openmmtools_tpu_torch.integrators import BAOABIntegrator

        bound = BAOABIntegrator(temperature=300.0, collision_rate=1.0,
                                timestep=0.002).bind(system)
        u, f = bound.energy_forces_at(x, box, {})
        return float(u), f.detach().cpu().double().numpy(), \
            "energy_forces_at"
    u_fn = make_energy_fn(system)
    u, g = value_and_grad(lambda xx: u_fn(xx, box), x)
    return float(u), (-g).detach().cpu().double().numpy(), "dense"


def kernel_path(bound):
    """'K1', 'K2', 'K2-alchemical' or None: the kernel path a bound
    integrator takes (its force path's name)."""
    name = bound.force_path.name
    return name if name.startswith("K") else None


def _kernel_check(ts, tolerance, device, u_ref64):
    """Compare the integrator's kernel path (K1's fused chunk, K2's sweep)
    against the dense float32 sum on the same device. Returns (status,
    detail, path, launches): the kernels' launch counts of the check."""
    import torch

    from openmmtools_tpu_torch.integrators import BAOABIntegrator
    from openmmtools_tpu_torch.states import SamplerState
    from openmmtools_tpu_torch.system import DENSE_LIMIT

    system = ts.system.to(device=device, dtype=torch.float32)
    bound = BAOABIntegrator(temperature=300.0, collision_rate=1.0,
                            timestep=0.002).bind(system)
    path = kernel_path(bound)
    if path is None:
        return "n/a", "", None, {}
    # K1's (lj_forces, lj_chunk) or K2's (sweep_bound, its forces kernel)
    counters = bound.force_path.kernel.launches
    before = dict(counters)
    x = ts.positions.to(device=device, dtype=torch.float32)
    ss = SamplerState(positions=x, box_vectors=system.default_box)
    gen = torch.Generator(device=device).manual_seed(0)
    state = bound.initial_state(ss, gen, temperature=300.0)
    if path == "K1":
        # 0 steps: the chunk kernel evaluates U, F of the input positions
        out = bound.run(state, 0)
        u_k = float(sum(p.double() for p in out.potentials))
    else:
        u_k = float(sum(p.double() for p in state.potentials))
    if device == "cuda":
        torch.cuda.synchronize()
    launches = {k: counters[k] - before[k] for k in counters}
    if system.n_particles >= DENSE_LIMIT and x.device.type == "cuda":
        u_ref, ref = u_ref64, "cpu/f64"
    else:
        with torch.no_grad():
            u_ref = float(system.energy(x, system.default_box))
        ref = "dense"
    du = abs(u_k - u_ref)
    ok = du <= tolerance * max(1.0, abs(u_ref) / 100.0)
    detail = (f"{path}: U_kernel={u_k:.4f} U_{ref}={u_ref:.4f} "
              f"|dU|={du:.2e} launches={launches}")
    if x.device.type == "cuda" and not all(launches.values()):
        ok = False
        detail += " (a kernel of the path launched nothing)"
    return ("ok" if ok else "FAIL"), detail, path, launches


def run_sweep(names=None, tolerance=ENERGY_TOLERANCE_KJ, include_slow=False,
              failure_dir="platform-failures", check_kernels=True,
              verbose=True, device=None):
    """Sweep ``names`` (default: the whole catalog) over the platforms of
    ``device`` (see :func:`platforms`). Returns (results, failures,
    skipped): a row of checks a system checked, a (name, check, row)
    a failing check, and a (name, reason) a system skipped."""
    import numpy as np
    import torch

    from openmmtools_tpu_torch.models import get_available_testsystems
    from openmmtools_tpu_torch.utils.platforms import get_fastest_platform

    if device is None:
        device = get_fastest_platform().lower()
    plats = platforms(device)
    names = names or get_available_testsystems()
    failures, results, skipped = [], [], []
    for name in names:
        if not include_slow and name in _SLOW:
            skipped.append((name, "slow; --include-slow"))
            if verbose:
                print(f"  - {name}: skipped (slow; --include-slow)")
            continue
        cls = _catalog_class(name)
        row = {"system": name, "checks": {}}
        if cls is None:
            row["checks"]["construct"] = "ERROR unknown system"
            failures.append((name, "construct", row))
            if verbose:
                print(f"  ! unknown system {name}")
            continue
        reason = None
        if _needs_arguments(cls):
            reason = "constructor needs arguments"
        else:
            try:
                ts = cls(device="cpu")
            except FileNotFoundError as e:
                reason = f"data not found: {str(e)[:80]}"
            except Exception as e:
                row["checks"]["construct"] = f"ERROR {type(e).__name__}: {e}"
                failures.append((name, "construct", row))
                if verbose:
                    print(f"  ! {name}: constructor ERROR {str(e)[:120]}")
                continue
        if reason is not None:
            skipped.append((name, reason))
            if verbose:
                print(f"  - {name}: skipped ({reason})")
            continue
        try:
            u_ref, f_ref, _ = _evaluate(ts.system, torch.float64, "cpu",
                                        ts.positions)
        except Exception as e:
            row["checks"]["cpu/f64"] = f"ERROR {type(e).__name__}: {e}"
            failures.append((name, "cpu/f64", row))
            if verbose:
                print(f"  ! {name}: cpu/f64 ERROR {str(e)[:120]}")
            continue
        row["U_ref"] = u_ref
        fscale = max(np.abs(f_ref).max(), 1.0)
        # |U| in float32 carries ~|U| 1e-7 of representation error; keep
        # the reference's absolute tolerance until it would be unattainable
        tol = tolerance * max(1.0, abs(u_ref) * 1e-5 / tolerance)
        ok_all = True
        for key in plats:
            dev = key.split("/")[0]
            try:
                u, f, via = _evaluate(ts.system, torch.float32, dev,
                                      ts.positions)
            except Exception as e:
                row["checks"][key] = f"ERROR {type(e).__name__}: {e}"
                ok_all = False
                failures.append((name, key, row))
                continue
            du = abs(u - u_ref)
            df = np.abs(f - f_ref).max() / fscale
            ok = du <= tol and df <= FORCE_RTOL
            row["checks"][key] = {
                "U": u, "U_ref": u_ref, "dU_kJ": du, "dF_rel": float(df),
                "via": via, "ok": bool(ok)}
            if not ok:
                ok_all = False
                failures.append((name, key, row))
        if check_kernels:
            try:
                status, detail, path, launches = _kernel_check(
                    ts, tolerance, device, u_ref)
            except Exception as e:
                status, detail, path, launches = (
                    "FAIL", f"ERROR {type(e).__name__}: {e}", None, {})
            row["checks"]["kernel"] = f"{status} {detail}"
            row["kernel_path"] = path
            row["kernel_launches"] = launches
            if status == "FAIL":
                ok_all = False
                failures.append((name, "kernel", row))
        results.append(row)
        if verbose:
            mark = "ok  " if ok_all else "FAIL"
            parts = []
            for key, v in row["checks"].items():
                if isinstance(v, dict):
                    parts.append(f"{key}: dU={v['dU_kJ']:.2e} "
                                 f"dF={v['dF_rel']:.1e}")
                elif key == "kernel":
                    parts.append(f"kernel: {v.split()[0]}"
                                 + (f" {row['kernel_path']} "
                                    f"{row['kernel_launches']}"
                                    if row.get("kernel_path") else ""))
            print(f"  {mark} {name}: U={u_ref:.3f}  " + "; ".join(parts))

    if failures:
        fdir = Path(failure_dir)
        fdir.mkdir(parents=True, exist_ok=True)
        for name, key, row in failures:
            stem = f"{name}-{key.replace('/', '-')}"
            (fdir / f"{stem}.json").write_text(
                json.dumps(row, indent=2, default=str))
            cls = _catalog_class(name)
            if cls is not None and key != "construct":
                np.savez(fdir / f"{stem}.npz",
                         positions=cls(device="cpu").positions.numpy())
        if verbose:
            print(f"{len(failures)} failing checks; repro files in {fdir}/")
    elif verbose:
        print(f"all {len(results)} systems consistent across {plats} vs "
              f"cpu/f64 (tol {tolerance:.3f} kJ/mol)"
              + (" + kernel paths" if check_kernels else ""))
    return results, failures, skipped


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--systems", nargs="*", default=None)
    parser.add_argument("--tolerance", type=float,
                        default=ENERGY_TOLERANCE_KJ)
    parser.add_argument("--include-slow", action="store_true")
    parser.add_argument("--no-kernels", action="store_true")
    parser.add_argument("--failure-dir", default="platform-failures")
    parser.add_argument("--device", choices=("cpu", "cuda"), default=None,
                        help="where the sweep runs (default: the card "
                             "when one is present)")
    args = parser.parse_args(argv)
    t0 = time.time()
    _, failures, _ = run_sweep(
        names=args.systems, tolerance=args.tolerance,
        include_slow=args.include_slow, failure_dir=args.failure_dir,
        check_kernels=not args.no_kernels, device=args.device)
    print(f"sweep finished in {time.time() - t0:.0f} s")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
