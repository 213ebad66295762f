"""Benchmark alchemical-system creation and energy/force evaluation
(counterpart of ``scripts/benchmark_alchemy.py``).

Times ``AbsoluteAlchemicalFactory.create_alchemical_system`` and the energy
and forces (autograd through ``make_energy_fn``) of the reference and the
alchemical LJ fluid, one alchemical atom, at lambda_sterics =
lambda_electrostatics = 0.5. On the card the clock is read after a
synchronize, so the times are those of the finished work.

Run: ``python -m openmmtools_tpu_torch.scripts.benchmark_alchemy
[--nparticles 512] [--n-iterations 100] [--device cuda|cpu]``.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--nparticles", type=int, default=512)
    parser.add_argument("--n-iterations", type=int, default=100)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch

    from openmmtools_tpu_torch.alchemy import (
        AbsoluteAlchemicalFactory,
        AlchemicalRegion,
    )
    from openmmtools_tpu_torch.models import LennardJonesFluid
    from openmmtools_tpu_torch.system import make_energy_fn, value_and_grad

    dev = torch.device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fluid = LennardJonesFluid(nparticles=args.nparticles, device=dev)
    factory = AbsoluteAlchemicalFactory()

    t0 = time.perf_counter()
    alch = factory.create_alchemical_system(
        fluid.system, AlchemicalRegion(alchemical_atoms=[0]))
    sync()
    creation = time.perf_counter() - t0
    print(f"create_alchemical_system: {creation * 1e3:.2f} ms (host)")

    x = fluid.positions
    box = fluid.system.default_box
    half = torch.tensor(0.5, dtype=x.dtype, device=dev)
    for label, system, params in (
            ("reference", fluid.system, {}),
            ("alchemical", alch, {"lambda_sterics": half,
                                  "lambda_electrostatics": half})):
        u_fn = make_energy_fn(system)

        def evaluate():
            return value_and_grad(lambda xx: u_fn(xx, box, params), x)

        u, _ = evaluate()   # warm-up
        sync()
        t0 = time.perf_counter()
        for _ in range(args.n_iterations):
            u, _ = evaluate()
        sync()
        per = (time.perf_counter() - t0) / args.n_iterations
        print(f"{label:10s} energy+force: {per * 1e6:.1f} us/eval "
              f"(U = {float(u):.3f} kJ/mol)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
