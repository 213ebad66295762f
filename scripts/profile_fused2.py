"""Decompose the fused kernel's marginal per-step cost.

Fits  time = A*steps + B*windows + C*rebuild_blocks + D*sweep_blocks
over runs varying sort_interval and skin, to separate per-step fixed
work (integration/noise/wrap), per-window work (argsort+gathers), and
per-block sweep work.  Run on the real TPU.
"""
import time

import jax
import numpy as np


def timed(fn, reps=3):
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(fn())
    return (time.perf_counter() - t0) / reps


def main():
    from openmmtools_tpu.integrators import BAOABIntegrator
    from openmmtools_tpu.models import LennardJonesFluid
    from openmmtools_tpu.ops.pallas_baoab import FusedSortedLangevin

    n = 2048
    fluid = LennardJonesFluid(nparticles=n)
    integ = BAOABIntegrator(temperature=120.0, collision_rate=1.0,
                            timestep=0.002)
    bound = integ.bind(fluid.system)
    state = bound.initial_state(fluid.sampler_state(), jax.random.PRNGKey(0),
                                temperature=120.0)
    state = jax.block_until_ready(bound.run(state, 20000))
    x, v, box, kT, key = (state.positions, state.velocities, state.box,
                          state.kT, state.rng_key)
    f0 = bound.force_path.kernel

    rows = []
    steps = 3200
    for si, skin in [(100, 0.102), (400, 0.102), (1600, 0.102),
                     (3200, 0.102), (100, 0.05), (100, 0.2), (100, 0.35),
                     (400, 0.2), (1600, 0.2)]:
        k = FusedSortedLangevin(n, f0.rc, f0.switch_width, f0.sigma,
                                f0.epsilon, f0.mass, f0.dt, f0.gamma,
                                skin=skin, sort_interval=si)
        dt = timed(lambda: k.run(x, v, box, kT, key, steps))
        stats = np.asarray(k.last_stats)
        n_win = max(1, steps // si)
        rebuilds, sum_bound = float(stats[0]), float(stats[1])
        n_blocks_full = k.n_pad // 2 // k.bs
        # total swept blocks: rebuilds sweep ALL blocks; others the bound.
        # bound applies per window (sum_bound = per-window bounds summed)
        avg_bound = sum_bound / n_win
        normal_sweeps = steps - rebuilds
        swept = rebuilds * n_blocks_full + normal_sweeps * avg_bound
        rows.append((steps, n_win, rebuilds, swept, avg_bound, dt))
        print(f"si={si:5d} skin={skin:5.3f}: {dt/steps*1e6:6.2f} us/step  "
              f"windows={n_win:3d} rebuilds={rebuilds:4.0f} "
              f"avg_bound={avg_bound:5.1f} swept_blocks={swept:9.0f}")

    # least squares: dt = A*steps + B*windows + C*swept_blocks + const
    M = np.array([[r[0], r[1], r[3], 1.0] for r in rows])
    y = np.array([r[5] for r in rows])
    coef, *_ = np.linalg.lstsq(M, y, rcond=None)
    print(f"\nfit: per-step {coef[0]*1e6:.2f} us + per-window "
          f"{coef[1]*1e6:.1f} us + per-block {coef[2]*1e9:.1f} ns "
          f"+ const {coef[3]*1e3:.1f} ms")
    print(f"at bound 28.7 blocks: sweep = {coef[2]*28.7*1e6:.2f} us/step")


if __name__ == "__main__":
    main()
