"""Absolute LJ-particle decoupling free energy by three independent routes
(counterpart of ``openmmtools_tpu/scripts/demo_free_energy.py``).

Route A (equilibrium): replica exchange over a lambda_sterics ladder of
compound thermodynamic states, the replicas propagated as one batch, then
MBAR with a block-analysis error.
Route B (nonequilibrium): NCMC switching, forward and reverse, all
protocols of a direction as one batch (the JAX script's vmap over
protocols), then BAR.
Route C (oracle): Widom test-particle insertion from the decoupled
ensemble, mu_ex = -kT ln <exp(-beta dU)>; the insertions of a snapshot
are one batched energy evaluation. At lambda_sterics = 0 the ghost is
ideal, so one-sided EXP from that ensemble is the textbook Widom chemical
potential, and dG(1 -> 0) = -mu_ex. It shares no ladder, MBAR or BAR
machinery with routes A and B.

At 216 particles the alchemical term is not one the sweep kernel takes
and the system is below sweep mode's 1,024 atoms, so every route runs the
generic program, batched, on the device: as the JAX script does at this
size.

Run: ``python -m openmmtools_tpu_torch.scripts.demo_free_energy [--device
cuda|cpu] [--n-iter 600] [--steps-per-iter 200] [--n-protocols 256]
[--n-steps-neq 6000] [--n-steps-eq 4000] [--n-snapshots 400]
[--steps-between 100] [--n-insertions 64] [--n-eq-widom 4000]``; the
defaults are the JAX script's depths. Exits 0 when the three routes agree
within 6 sigma; the last line is a JSON summary (each route's dG, its
error and its seconds).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

TEMP = 120.0
N_PARTICLES = 216
DENSITY = 0.30
N_STATES = 8
N_ITER = 600
STEPS_PER_ITER = 200
N_PROTOCOLS = 256
N_STEPS_NEQ = 6000
N_STEPS_EQ = 4000


def build(device, dtype=None):
    """The LJ fluid, its system with particle 0 alchemical, and the
    compound state at full coupling."""
    from openmmtools_tpu_torch.alchemy import (
        AbsoluteAlchemicalFactory,
        AlchemicalRegion,
        AlchemicalState,
    )
    from openmmtools_tpu_torch.models import LennardJonesFluid
    from openmmtools_tpu_torch.states import (
        CompoundThermodynamicState,
        ThermodynamicState,
    )

    fluid = LennardJonesFluid(nparticles=N_PARTICLES,
                              reduced_density=DENSITY, device=device)
    alch_system = AbsoluteAlchemicalFactory().create_alchemical_system(
        fluid.system, AlchemicalRegion(alchemical_atoms=[0]))
    if dtype is not None:
        alch_system = alch_system.to(dtype=dtype)
    compound = CompoundThermodynamicState(
        base_state=ThermodynamicState(alch_system, TEMP),
        composable_states=[AlchemicalState(lambda_sterics=1.0,
                                           lambda_electrostatics=1.0)])
    return fluid, alch_system, compound


def _positions(fluid, system):
    import torch

    return torch.as_tensor(fluid.positions, dtype=system.masses.dtype,
                           device=system.device)


def route_a_remd(fluid, compound, n_iter, steps_per_iter):
    """REMD over N_STATES lambda_sterics values -> MBAR; the error from
    the spread of 4 time blocks (the replicas' samples are correlated)."""
    from openmmtools_tpu_torch.mcmc import LangevinSplittingDynamicsMove
    from openmmtools_tpu_torch.multistate import ReplicaExchangeSampler
    from openmmtools_tpu_torch.multistate.mbar import mbar_free_energies
    from openmmtools_tpu_torch.states import (
        SamplerState,
        create_thermodynamic_state_protocol,
    )

    lambdas = np.linspace(1.0, 0.0, N_STATES)
    states = create_thermodynamic_state_protocol(
        compound, {"lambda_sterics": lambdas},
        constants={"lambda_electrostatics": 1.0})
    move = LangevinSplittingDynamicsMove(
        timestep=0.002, collision_rate=1.0, n_steps=steps_per_iter,
        splitting="V R O R V")
    sampler = ReplicaExchangeSampler(
        mcmc_moves=move, number_of_iterations=n_iter,
        online_analysis_interval=None, rng_seed=1)
    x0 = _positions(fluid, compound.system)
    sampler.create(states, [SamplerState(positions=x0)
                            for _ in range(N_STATES)])
    t0 = time.perf_counter()
    sampler.run()
    dt = time.perf_counter() - t0
    print(f"REMD ({sampler.propagation_route} route): {n_iter} iterations "
          f"in {dt:.1f} s ({dt / max(n_iter, 1) * 1e3:.1f} ms/iter)",
          flush=True)

    burn = n_iter // 3
    u_hist = np.asarray(sampler._energy_history[burn:])[::3]   # (T, N, K)
    s_hist = np.asarray(sampler._state_history[burn:])[::3]    # (T, N)
    u_kn = u_hist.reshape(-1, N_STATES).T
    n_k = np.bincount(s_hist.ravel(), minlength=N_STATES)
    res = mbar_free_energies(u_kn, n_k)
    df = float(res.delta_f(0, N_STATES - 1)[0])
    n_blocks = 4
    t_total = u_hist.shape[0]
    block_dfs = []
    for b in range(n_blocks):
        sl = slice(b * t_total // n_blocks, (b + 1) * t_total // n_blocks)
        u_b = u_hist[sl].reshape(-1, N_STATES).T
        n_b = np.bincount(s_hist[sl].ravel(), minlength=N_STATES)
        r = mbar_free_energies(u_b, n_b, compute_theta=False)
        block_dfs.append(float(r.free_energies[-1] - r.free_energies[0]))
    ddf = float(np.std(block_dfs) / np.sqrt(n_blocks))
    return df, ddf, dt


def ncmc_works(fluid, alch_system, forward, seed, n_protocols, n_steps_eq,
               n_steps_neq, velocities=None, collision_rate=1.0):
    """Reduced protocol work (n_protocols,) of a batch of NCMC switches
    (forward: lambda_sterics 1 -> 0, reverse 0 -> 1), each protocol
    equilibrated ``n_steps_eq`` steps at its starting lambda first
    (BAOAB), then ``n_steps_neq`` steps of 'V R H R V O'. Protocol k
    draws from generators seeded from (seed, k). ``velocities`` (optional,
    (n_protocols, N, 3)) start the equilibration."""
    import torch

    from openmmtools_tpu_torch.constants import kB
    from openmmtools_tpu_torch.integrators import (
        AlchemicalNonequilibriumLangevinIntegrator,
        BAOABIntegrator,
    )
    from openmmtools_tpu_torch.multistate.sampler import derived_seed
    from openmmtools_tpu_torch.states import SamplerState

    start = 1.0 if forward else 0.0
    integ = AlchemicalNonequilibriumLangevinIntegrator(
        alchemical_functions={"lambda_sterics": ("1.0 - lambda" if forward
                                                 else "lambda")},
        splitting="V R H R V O", temperature=TEMP,
        collision_rate=collision_rate, timestep=0.002,
        n_steps_neq=n_steps_neq)
    bound = integ.bind(alch_system)
    eq_bound = BAOABIntegrator(temperature=TEMP, collision_rate=collision_rate,
                               timestep=0.002).bind(alch_system)
    params0 = {"lambda_sterics": start, "lambda_electrostatics": 1.0}
    device = alch_system.device
    x0 = _positions(fluid, alch_system)

    def generators(stream):
        return [torch.Generator(device=device).manual_seed(
            derived_seed(seed, k, stream)) for k in range(n_protocols)]

    start_states = [SamplerState(
        positions=x0, velocities=None if velocities is None
        else velocities[k]) for k in range(n_protocols)]
    es = eq_bound.initial_state_batch(start_states, generators(0),
                                      temperatures=TEMP,
                                      global_params=params0)
    es = eq_bound.run_program(n_steps_eq)(es)
    ns = bound.initial_state_batch(
        [SamplerState(positions=es.positions[k], velocities=es.velocities[k])
         for k in range(n_protocols)], generators(1), temperatures=TEMP,
        global_params=params0)
    ns = bound.run_program(n_steps_neq)(ns)
    return ns.protocol_work.to(torch.float64) / (kB * TEMP)


def route_b_ncmc(fluid, alch_system, forward, seed, n_protocols, n_steps_eq,
                 n_steps_neq):
    t0 = time.perf_counter()
    w = ncmc_works(fluid, alch_system, forward, seed, n_protocols,
                   n_steps_eq, n_steps_neq).cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"NCMC {'fwd' if forward else 'rev'}: {n_protocols} protocols x "
          f"{n_steps_eq}+{n_steps_neq} steps in {dt:.1f} s; "
          f"<w> = {w.mean():.3f} kT", flush=True)
    return w, dt


def route_c_widom(fluid, compound, seed=33, n_snapshots=400,
                  steps_between=100, n_insertions=64, n_eq=4000):
    """Widom insertion from the decoupled (lambda_sterics = 0) ensemble:
    MD of the (N-1)-particle fluid with the ghost ideal, and at each
    snapshot the coupling energy dU = u(lambda = 1) - u(lambda = 0) at
    ``n_insertions`` uniform ghost positions, all 2 n_insertions
    (position, lambda) pairs in one batched evaluation. Returns
    f(1) - f(0) = beta mu_ex, its block-analysis error and the seconds."""
    import torch

    from openmmtools_tpu_torch.constants import kB
    from openmmtools_tpu_torch.integrators import BAOABIntegrator
    from openmmtools_tpu_torch.states import SamplerState

    system = compound.system
    device = system.device
    dtype = system.masses.dtype
    params0 = {"lambda_sterics": 0.0, "lambda_electrostatics": 1.0}
    bound = BAOABIntegrator(temperature=TEMP, collision_rate=1.0,
                            timestep=0.002).bind(system)
    gen = torch.Generator(device=device).manual_seed(seed)
    ins_gen = torch.Generator(device=device).manual_seed(seed + 1)
    es = bound.initial_state(SamplerState(positions=_positions(fluid, system)),
                             gen, temperature=TEMP, global_params=params0)
    run = bound.run_program(steps_between)
    es = bound.run_program(n_eq)(es)
    box = system.default_box.to(dtype)
    box_l = float(box[0, 0])
    beta = 1.0 / (kB * TEMP)
    # pairs (insertion i, lambda): 0..R-1 at lambda 1, R..2R-1 at lambda 0
    rep = torch.arange(2 * n_insertions, device=device) % n_insertions
    lam = torch.cat([torch.ones(n_insertions), torch.zeros(n_insertions)])
    params = {"lambda_sterics": lam.to(device=device, dtype=dtype),
              "lambda_electrostatics": torch.ones(
                  2 * n_insertions, device=device, dtype=dtype)}
    boxes = box.expand(n_insertions, 3, 3)
    t0 = time.perf_counter()
    dus = []
    with torch.no_grad():
        for _ in range(n_snapshots):
            es = run(es)
            r = torch.rand((n_insertions, 3), generator=ins_gen,
                           device=device, dtype=dtype) * box_l
            x = es.positions.expand(n_insertions, -1, -1).clone()
            x[:, 0] = r
            u, overflow = bound.energies_batch(x, boxes, rep, params)
            bound.check_sweep_overflow(overflow)
            dus.append(beta * (u[:n_insertions] - u[n_insertions:]))
    dus = torch.stack(dus).cpu().numpy()                      # (T, R)
    dt = time.perf_counter() - t0
    print(f"Widom: {n_snapshots} snapshots x {n_insertions} insertions in "
          f"{dt:.1f} s; min dU = {dus.min():.2f} kT", flush=True)

    def f_of(block):
        return -float(np.log(np.exp(-block).mean()))

    f_all = f_of(dus)
    n_blocks = 8
    t_tot = dus.shape[0]
    blocks = [f_of(dus[b * t_tot // n_blocks:(b + 1) * t_tot // n_blocks])
              for b in range(n_blocks)]
    return f_all, float(np.std(blocks) / np.sqrt(n_blocks)), dt


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--n-iter", type=int, default=N_ITER)
    parser.add_argument("--steps-per-iter", type=int, default=STEPS_PER_ITER)
    parser.add_argument("--n-protocols", type=int, default=N_PROTOCOLS)
    parser.add_argument("--n-steps-neq", type=int, default=N_STEPS_NEQ)
    parser.add_argument("--n-steps-eq", type=int, default=N_STEPS_EQ)
    parser.add_argument("--n-snapshots", type=int, default=400)
    parser.add_argument("--steps-between", type=int, default=100)
    parser.add_argument("--n-insertions", type=int, default=64)
    parser.add_argument("--n-eq-widom", type=int, default=4000)
    args = parser.parse_args(argv)

    import torch

    from openmmtools_tpu_torch.constants import kB
    from openmmtools_tpu_torch.multistate.mbar import bar_free_energy

    device = torch.device(args.device)
    print(f"device={device}  N={N_PARTICLES} rho*={DENSITY} T={TEMP}K  "
          f"decoupling particle 0 sterics", flush=True)
    fluid, alch_system, compound = build(device)
    df_a, ddf_a, t_a = route_a_remd(fluid, compound, args.n_iter,
                                    args.steps_per_iter)
    print(f"Route A (REMD/MBAR):  dG = {df_a:.3f} +- {ddf_a:.3f} kT",
          flush=True)
    w_f, t_f = route_b_ncmc(fluid, alch_system, True, 21, args.n_protocols,
                            args.n_steps_eq, args.n_steps_neq)
    w_r, t_r = route_b_ncmc(fluid, alch_system, False, 22, args.n_protocols,
                            args.n_steps_eq, args.n_steps_neq)
    df_b, ddf_b = (float(v) for v in bar_free_energy(w_f, w_r))
    print(f"Route B (NCMC/BAR):   dG = {df_b:.3f} +- {ddf_b:.3f} kT",
          flush=True)
    # Widom gives f(1) - f(0); routes A and B measure f(0) - f(1)
    f_c, ddf_c, t_c = route_c_widom(
        fluid, compound, n_snapshots=args.n_snapshots,
        steps_between=args.steps_between, n_insertions=args.n_insertions,
        n_eq=args.n_eq_widom)
    df_c = -f_c
    print(f"Route C (Widom EXP):  dG = {df_c:.3f} +- {ddf_c:.3f} kT "
          f"(beta*mu_ex = {f_c:.3f})", flush=True)
    kcal = kB * TEMP / 4.184
    worst = 0.0
    for name, (d1, e1), (d2, e2) in (
            ("A vs B", (df_a, ddf_a), (df_b, ddf_b)),
            ("A vs Widom", (df_a, ddf_a), (df_c, ddf_c)),
            ("B vs Widom", (df_b, ddf_b), (df_c, ddf_c))):
        sigma = max((e1 ** 2 + e2 ** 2) ** 0.5, 0.02)
        dev = abs(d1 - d2) / sigma
        worst = max(worst, dev)
        print(f"agreement {name}: |d| = {abs(d1 - d2):.3f} kT = "
              f"{abs(d1 - d2) * kcal:.3f} kcal/mol ({dev:.1f} sigma)",
              flush=True)
    summary = {"dG_kT": {"A": df_a, "B": df_b, "C": df_c},
               "err_kT": {"A": ddf_a, "B": ddf_b, "C": ddf_c},
               "seconds": {"A": t_a, "B": t_f + t_r, "C": t_c},
               "worst_sigma": worst, "device": str(device)}
    print(json.dumps(summary), flush=True)
    return 0 if worst < 6.0 else 1


if __name__ == "__main__":
    sys.exit(main())
