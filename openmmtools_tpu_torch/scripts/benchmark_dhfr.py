"""DHFR (JAC, 23,558 atoms, PME, h-bond constraints) production MD
benchmark (counterpart of ``scripts/benchmark_dhfr.py``): the reference's
flagship explicit-solvent system (``models.DHFRExplicit``).

On the card the bound integrator takes sweep mode: K2's bounded-sweep
direct space, the Ewald reciprocal term and the exception add-back around
it, and SETTLE on the waters with M-SHAKE on the solute's hydrogen
clusters, through the standard BAOAB integrator. The script checks the
initial energy against a float64 plain evaluation on the CPU (the kernels'
plain versions, in sweep mode: the card refuses the dense sum at this
size) within 1e-3, runs one untimed chunk of ``--steps`` and one timed,
asserts finite positions and no exclusion-bitfield overflow, and reports
ms a step, steps/s and ns/day.

Usage: python -m openmmtools_tpu_torch.scripts.benchmark_dhfr [--steps
1000] [--timestep 0.002] [--no-check] [--reference-defaults] [--device
cuda|cpu]. The data come from ``$OPENMMTOOLS_TPU_DATA/dhfr/``.
"""
import argparse
import sys
import time


def plain_energy(system, positions, box):
    """U of ``system`` at ``positions`` in float64 on the CPU, by the sweep
    path's plain versions (sweep mode forced)."""
    import torch

    from openmmtools_tpu_torch.integrators import BAOABIntegrator

    s64 = system.to(device="cpu", dtype=torch.float64)
    bound = BAOABIntegrator(temperature=300.0, sweep="force").bind(s64)
    u, _ = bound.energy_forces_at(
        positions.detach().to(device="cpu", dtype=torch.float64),
        box.to(device="cpu", dtype=torch.float64), {})
    return float(u)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--timestep", type=float, default=0.002)
    p.add_argument("--no-check", action="store_true")
    p.add_argument("--reference-defaults", action="store_true",
                   help="the reference test system's configuration "
                        "(cutoff 1.0 nm, switch 0.15 nm, Ewald tolerance "
                        "1e-5) instead of the JAC convention (0.9 nm hard "
                        "cutoff, tolerance 5e-4)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)

    import torch

    from openmmtools_tpu_torch.integrators import BAOABIntegrator
    from openmmtools_tpu_torch.models import DHFRExplicit

    device = torch.device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    if args.reference_defaults:
        d = DHFRExplicit(cutoff=1.0, switch_width=0.15,
                         ewald_error_tolerance=1e-5, device=device)
        print("config: reference testsystem defaults "
              "(cutoff 1.0 nm, switch 0.15 nm, tol 1e-5)", flush=True)
    else:
        d = DHFRExplicit(device=device)
    print(f"DHFR built in {time.perf_counter() - t0:.2f} s: "
          f"{d.system.n_particles} atoms, "
          f"{d.system.constraints.n_constraints} constraints, "
          f"device={device}", flush=True)

    t0 = time.perf_counter()
    bound = BAOABIntegrator(temperature=300.0, collision_rate=1.0,
                            timestep=args.timestep).bind(d.system)
    print(f"direct-space path: {bound.force_path.name} (bound in "
          f"{time.perf_counter() - t0:.2f} s)", flush=True)

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    state = bound.initial_state(d.sampler_state(), gen, temperature=300.0)
    u0 = float(sum(u.double() for u in state.potentials))
    print(f"initial energy {u0:,.1f} kJ/mol "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)

    if not args.no_check:
        t0 = time.perf_counter()
        u_ref = plain_energy(d.system, state.positions, state.box
                             if state.box is not None
                             else d.system.default_box)
        rel = abs(u0 - u_ref) / abs(u_ref)
        print(f"plain float64 parity on the CPU: {u_ref:,.1f} kJ/mol (rel "
              f"diff {rel:.2e}; {time.perf_counter() - t0:.2f} s)",
              flush=True)
        assert rel < 1e-3, "kernel/plain energy mismatch"

    t0 = time.perf_counter()
    state = bound.run(state, args.steps)
    sync()
    print(f"first {args.steps}-step chunk: {time.perf_counter() - t0:.2f} s",
          flush=True)

    t0 = time.perf_counter()
    state = bound.run(state, args.steps)
    finite = bool(torch.isfinite(state.positions).all())
    dt = (time.perf_counter() - t0) / args.steps
    assert finite, "non-finite positions"
    assert state.sweep_overflow is None or not bool(state.sweep_overflow), \
        "exclusion bitfield overflow"
    ns_day = args.timestep * 86400.0 / dt / 1e3
    u = float(sum(u.double() for u in state.potentials))
    print(f"{args.steps} steps: {dt * 1e3:.2f} ms/step -> {1.0 / dt:,.1f} "
          f"steps/s, {ns_day:.2f} ns/day (U = {u:,.0f} kJ/mol)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
