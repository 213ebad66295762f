"""Alanine-dipeptide parallel-tempering throughput benchmark (counterpart
of ``scripts/benchmark_remd.py``; 128 replicas by default).

Runs ``ParallelTemperingSampler`` over a 270-600 K ladder on
``AlanineDipeptideVacuum`` with a Langevin move ('V R O R V', 2 fs). The
replicas advance as one batch (the sampler's batched route, where the JAX
script vmaps them into one program); with ``--mesh N`` they are split over
a replica mesh of N devices (``parallel.replica_mesh``): the cards, or N
CPU devices under ``--device cpu``. ``--sync K`` runs K iterations between
host reports (``iterations_per_sync``). ``--check`` re-runs the mesh's
first iteration on one device with the same seed and compares the
energies.

Usage:
    python -m openmmtools_tpu_torch.scripts.benchmark_remd \
        [--replicas 128] [--steps 250] [--iters 6] [--sync 1] [--mesh N] \
        [--check] [--device cuda|cpu]

The data come from ``$OPENMMTOOLS_TPU_DATA/alanine-dipeptide-gbsa/``.
"""
import argparse
import sys
import time


def _mesh(n_devices, device):
    import torch

    from openmmtools_tpu_torch.parallel import replica_mesh

    if device.type == "cpu":
        return replica_mesh(devices=[torch.device("cpu")] * n_devices)
    return replica_mesh(n_devices)


def _build_sampler(n_replicas, n_steps_per_iter, n_iterations, sync, mesh,
                   device):
    from openmmtools_tpu_torch.mcmc import LangevinSplittingDynamicsMove
    from openmmtools_tpu_torch.models import AlanineDipeptideVacuum
    from openmmtools_tpu_torch.multistate import ParallelTemperingSampler
    from openmmtools_tpu_torch.states import SamplerState

    ala = AlanineDipeptideVacuum(device=device)
    ref = ala.thermodynamic_state(300.0)
    move = LangevinSplittingDynamicsMove(
        timestep=0.002, collision_rate=1.0, n_steps=n_steps_per_iter,
        splitting="V R O R V")
    sampler = ParallelTemperingSampler(
        mcmc_moves=move, number_of_iterations=n_iterations,
        online_analysis_interval=None, rng_seed=0,
        iterations_per_sync=sync)
    sampler.create(ref, SamplerState(positions=ala.positions),
                   min_temperature=270.0, max_temperature=600.0,
                   n_temperatures=n_replicas, mesh=mesh)
    return ala, sampler


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--replicas", type=int, default=128)
    p.add_argument("--steps", type=int, default=250)
    p.add_argument("--iters", type=int, default=6)
    p.add_argument("--sync", type=int, default=1)
    p.add_argument("--mesh", type=int, default=0)
    p.add_argument("--check", action="store_true")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    device = torch.device(args.device)
    mesh = _mesh(args.mesh, device) if args.mesh else None
    ala, sampler = _build_sampler(args.replicas, args.steps, args.iters,
                                  args.sync, mesh, device)
    print(f"{args.replicas} replicas x {ala.system.n_particles} atoms, "
          f"{args.steps} MD steps/iter, sync={args.sync}, "
          f"mesh={args.mesh or 1}, device={device}, route "
          f"{sampler.propagation_route}", flush=True)

    t0 = time.perf_counter()
    sampler.extend(max(args.sync, 1))   # one-time costs + first window
    print(f"first window: {time.perf_counter() - t0:.2f} s", flush=True)

    t0 = time.perf_counter()
    n_timed = args.iters - max(args.sync, 1)
    if n_timed > 0:
        sampler.extend(n_timed)
    u = sampler.energies_last_iteration
    dt = (time.perf_counter() - t0) / max(n_timed, 1)
    assert np.all(np.isfinite(u)), "non-finite energies"
    print(f"{dt * 1e3:.1f} ms/iteration -> {3600.0 / dt:,.0f} "
          f"iterations/hour ({args.steps / dt:,.0f} MD steps/s aggregate x "
          f"{args.replicas} replicas = {args.replicas * args.steps / dt:,.0f}"
          f" replica-steps/s)", flush=True)

    if args.check and mesh is not None:
        # the mesh against one device from the same seed: the initial
        # energy matrix, and after one 1-step iteration (the JAX script's
        # tolerances: alanine's vacuum Coulomb sum runs through ~2e6 kJ/mol
        # intermediates in float32)
        _, sharded = _build_sampler(args.replicas, 1, 1, 1, mesh, device)
        _, single = _build_sampler(args.replicas, 1, 1, 1, None, device)
        err0 = float(np.max(np.abs(sharded.energies_last_iteration
                                   - single.energies_last_iteration)))
        sharded.extend(1)
        single.extend(1)
        err1 = float(np.max(np.abs(sharded.energies_last_iteration
                                   - single.energies_last_iteration)))
        print(f"single-device re-verification: initial |du| = {err0:.2e}, "
              f"after 1 step |du| = {err1:.2e}", flush=True)
        assert err0 < 0.3, "sharded initial energies diverge"
        assert err1 < 1.0, "sharded 1-step energies diverge"
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
