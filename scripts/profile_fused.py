"""Profile the fused sorted Langevin kernel on the bench config.

Decomposes the per-step cost of the driver bench (BAOAB, LJ-2048):
window overhead (argsort + gathers + chunk-start full sweep), per-block
sweep cost (via varying the shell bound), noise cost (gamma=0 variant),
and rebuild cadence.  Run on the real TPU chip (one process!).
"""
import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np


def timed(fn, *args, reps=5):
    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) / reps, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=2000)
    args = ap.parse_args()

    from openmmtools_tpu.integrators import BAOABIntegrator
    from openmmtools_tpu.models import LennardJonesFluid

    fluid = LennardJonesFluid(nparticles=args.n)
    integ = BAOABIntegrator(temperature=120.0, collision_rate=1.0,
                            timestep=0.002)
    bound = integ.bind(fluid.system)
    state = bound.initial_state(fluid.sampler_state(), jax.random.PRNGKey(0),
                                temperature=120.0)
    fused = bound.force_path.kernel
    print(f"n={args.n} n_pad={fused.n_pad} bs={fused.bs} "
          f"rc={fused.rc:.3f} sw={fused.switch_width} skin={fused.skin:.3f} "
          f"sort_interval={fused.sort_interval}")

    # equilibrate to steady state (condensed droplet)
    state = jax.block_until_ready(bound.run(state, 20000))

    # full bench chunks at several sort intervals
    for si in (50, 100, 200, 400):
        fused.sort_interval = si
        fused._run_cache.clear()
        x, v, box, kT, key = (state.positions, state.velocities, state.box,
                              state.kT, state.rng_key)
        dt, (xo, vo, fo, uo, k2) = timed(
            lambda: fused.run(x, v, box, kT, key, args.steps), reps=3)
        stats = np.asarray(fused.last_stats)
        n_win = max(1, args.steps // si)
        print(f"sort_interval={si:4d}: {args.steps/dt:9.0f} steps/s "
              f"({dt/args.steps*1e6:6.2f} us/step)  rebuilds={stats[0]:.0f} "
              f"avg_bound={stats[1]/n_win:.1f} blocks "
              f"({stats[1]/n_win*fused.bs:.0f} shells of {fused.n_pad//2})")

    # window-size scaling at fixed sort interval: marginal per-step cost
    fused.sort_interval = 100
    fused._run_cache.clear()
    x, v, box, kT, key = (state.positions, state.velocities, state.box,
                          state.kT, state.rng_key)
    times = {}
    for n_steps in (400, 800, 1600, 3200):
        dt, _ = timed(lambda ns=n_steps: fused.run(x, v, box, kT, key, ns),
                      reps=3)
        times[n_steps] = dt
        print(f"n_steps={n_steps:5d}: {dt*1e3:8.2f} ms total "
              f"({dt/n_steps*1e6:6.2f} us/step)")
    marg = (times[3200] - times[1600]) / 1600
    print(f"marginal per-step cost: {marg*1e6:.2f} us "
          f"(fixed per-call overhead ~ {(times[400] - 400*marg)*1e3:.2f} ms)")

    # noise cost: gamma=0 variant (no O noise draw)
    from openmmtools_tpu.ops.pallas_baoab import FusedSortedLangevin

    nf = FusedSortedLangevin(args.n, fused.rc, fused.switch_width,
                             fused.sigma, fused.epsilon, fused.mass,
                             fused.dt, 0.0, sort_interval=100)
    dt0, _ = timed(lambda: nf.run(x, v, box, kT, key, 1600), reps=3)
    print(f"gamma=0 (no noise): {dt0/1600*1e6:6.2f} us/step "
          f"(noise cost ~ {(times[1600]-dt0)/1600*1e6:.2f} us/step)")

    # switch-off variant: per-slot math cost of the switch region
    nsw = FusedSortedLangevin(args.n, fused.rc, None,
                              fused.sigma, fused.epsilon, fused.mass,
                              fused.dt, 1.0, sort_interval=100)
    dt1, _ = timed(lambda: nsw.run(x, v, box, kT, key, 1600), reps=3)
    print(f"no-switch: {dt1/1600*1e6:6.2f} us/step")

    # bs sweep: different shell-block sizes
    for bs in (8, 16, 32):
        kb = FusedSortedLangevin(args.n, fused.rc, fused.switch_width,
                                 fused.sigma, fused.epsilon, fused.mass,
                                 fused.dt, 1.0, shell_block=bs,
                                 sort_interval=100)
        dtb, _ = timed(lambda: kb.run(x, v, box, kT, key, 1600), reps=3)
        stats = np.asarray(kb.last_stats)
        print(f"bs={bs:2d}: {dtb/1600*1e6:6.2f} us/step  "
              f"avg_bound={stats[1]/16:.1f} blocks")


if __name__ == "__main__":
    main()
