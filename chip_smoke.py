"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, drive.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card; it builds the CUDA
kernels from ``openmmtools_tpu_torch/csrc`` itself (``ops/_build.py``). Each
phase prints a line, and any failure ends the run with a traceback and a
nonzero exit. Phases:

1. device: the card's name and ``nvidia-smi`` name and power limit; no CUDA
   means exit 1 (there is no CPU path);
2. build: nvcc of each ``csrc/*.cu``, all at once, with the time;
3. K1's kernels against their plain PyTorch versions on the card, at the LJ
   path's shapes (LJ fluid, N = 2048): forces and energy, and the chunk
   kernel, one launch a 40-step chunk, for four splittings and a two-sweep
   one, without and with noise, at N = 2048 and at a ragged N = 1000;
4. noise statistics: BAOAB at 120 K through the bound integrator, mean
   kinetic temperature within 5 %;
5. the LJ main path as bench.py drives it (LennardJonesFluid(2048) ->
   BAOABIntegrator(120 K, 1/ps, 2 fs) -> bind -> initial_state -> run in
   50,000-step chunks), with a host fetch of positions each chunk, the
   kernels' launch counts (one chunk kernel a chunk, one force kernel for
   the initial state), steps/s, the chunk kernel's share of a chunk's wall
   time, and kernel and plain times;
6. K2's kernels (the bounded sweep) against their plain versions at the
   explicit-solvent shapes (24,000 atoms, 24,064 slots): PME with the LJ
   switch, reaction field, and the Coulomb switch, each with the bound
   re-measured and passed through, and each launch repeated on the same
   inputs to the same bits (the bound's to the same int);
7. the explicit-solvent main path: PMEWaterBox(box_edge=6.223) (8,000
   rigid TIP3P waters, PME) -> BAOABIntegrator(300 K, 1/ps, 2 fs) -> bind
   (sweep mode, SETTLE) -> initial_state -> run, warmed up for 5,000 steps
   and timed in 1,000-step chunks that each end in a host fetch of the
   positions; launch counts, steps/s and ns/day, the kinetic temperature, the
   rigid geometry, the final energy and forces against the plain versions,
   K2 and PME times (K2's beside its earlier kernels'), K2's queue drains
   a slot and its time with no pair inside the cutoff, how many of
   ``sweep_bound``'s launches rebuild over 1,000 untimed steps and its time
   without a rebuild; ``sweep_bound`` on a rebuild, by its launches'
   device time, on the final state's fresh sort and on the path's own stale
   ring (its last rebuild before a re-sort, the ring its ``kernels`` entry
   reports), each launched twice to the same int as the plain version, with
   its floor there (the tile tests that no order of its scan can skip)
   beside the pairs within w in x and the whole ring's; and a profile of
   the step with K2's device ms a step;
8. K2's alchemical variant against its plain version on the alchemical
   water box (AlchemicalWaterBox(box_edge=6.223), 24,064 slots) at a fresh
   sort: one region with the direct-space treatment at lambda 1, 0.5 and 0,
   the 'exact' and 'coulomb' treatments at 0.55, and two regions, with and
   without their interaction; the bound, forces, energy and times of each,
   and two launches of each kernel on the same inputs to the same bits;
9. the alchemical main path (Path A): AlchemicalWaterBox(box_edge=6.223) ->
   a CompoundThermodynamicState of AlchemicalState(lambda_electrostatics=0,
   lambda_sterics=0.5) at 300 K -> BAOABIntegrator(300 K, 1/ps, 2 fs) ->
   bind (sweep mode with the alchemical kernel, SETTLE) -> initial_state ->
   run: 2,000 warm-up steps, then 1,000-step chunks that each end in a host
   fetch; launch counts, steps/s and ns/day, the kinetic temperature, the
   rigid geometry, the final energy and forces against the plain versions,
   the bound on the path's own ring and on a fresh sort against the plain
   version, K2-alchemical's times (beside its earlier kernel's), a profile
   of the step with K2's device ms a step, and on a 3,000-atom box the
   sweep path against the dense alchemical term;
10. the NCMC path (Path B) on the same box:
   AlchemicalNonequilibriumLangevinIntegrator(lambda_electrostatics = 1 -
   lambda, 500 steps, 'O { V R H R V } O') for one whole protocol, and a
   10-step external perturbation (lambda_electrostatics 1 -> 0 in steps of
   0.1) whose protocol work is held against the same energy differences
   summed outside the integrator; steps/s and ns/day of the protocol, and
   the bound on the protocol's own ring at its end against the plain
   version;
11. K3 (FusedDenseBAOAB: the chunk kernel with "V R O R V", one
   cooperative launch a chunk) on LJ-2048 against its plain version (K1's
   plain chunk for "V R O R V"): F and U at n_steps = 0, 40-step chunks at
   gamma 0 and 1 on one seed; then ``run`` as bench.py drives a run, a
   50,000-step warm-up and 50,000-step chunks each ending in a host fetch,
   its launches, steps/s, the final U and F against the dense evaluation,
   the kinetic temperature, its time per step beside the plain version and
   the bound, and one evaluation at 0 steps beside K1's force kernel;
12. K4's kernels (FusedLJBAOAB's cell-grid forces and chunk) on LJ-2048: the
   grid spec, the forces against the plain version and the dense sum, a
   noisy 40-step run across a rebin against the plain run, a gamma = 0
   100-step run (rebin every 25 steps) from a FIRE-minimized start against
   K3's kernel, the kinetic temperature, ``run`` in 50,000-step chunks from
   that start with capacity and occupancy a chunk, the final forces against
   the dense sum; at the main path's fullest bin the forces and a noisy
   40-step chunk against the plain versions, both kernels launched twice to
   the same bits, the kernels', rebin's and plain versions' times and
   bounds, the split of a step (the grid barrier and the forces' launch,
   each measured on an empty bin, against the staging, the pairs and the
   update) and of one chunk of ``run`` (the kernels' device time against
   the rest); and K4's forces beside K1's on LennardJonesFluid(16384);
13. the MCMC layer: (a) an NPT MCMCSampler run on LJ-2048 (120 K, rho kT
   = 21.1 bar), 10 iterations of a SequenceMove of LangevinDynamicsMove
   (2 fs, 5,000 steps: K1's fused chunk), GHMCMove (1 fs, 100 steps) and
   HMCMove (10 x 10 inner steps; both in sweep mode: K2),
   MCDisplacementMove (one atom) and MonteCarloBarostatMove (5 attempts),
   whose energies come from the global context cache's bound integrator
   (K1's force kernel here: two launches an attempt, 12 an iteration):
   the engine of each bound, K1's and K2's launches by move, acceptances,
   finite states, each integrator move's final U against the dense sum at
   the box it was handed (the barostat's), wall ms per apply, K1's and
   K2's event spans on the path, and K2's kernels timed with the stream
   held at the GHMC move's final state; (b) the Andersen, HMC and Metropolis MC integrators
   (their own steps) on the same fluid: no fused path, no sweep mode, no
   chunk launch, Andersen's kinetic temperature within 5 %, acceptances;
   (c) GHMCMove (1 fs, 2 x 50 steps) on PMEWaterBox(6.223): sweep mode, K2
   and SETTLE inside the Metropolized block, acceptance, rigid geometry,
   and the final U and forces against the plain sweep plus the remainder;
14. the multistate layer: (a) replica exchange on the alchemical water box
   (AlchemicalWaterBox(box_edge=6.223), 9 states of a lambda ladder that
   turns the electrostatics off, then the sterics, at 300 K; 9 replicas
   from one state, FIRE-minimized through the bound integrator's sweep
   path) -> ReplicaExchangeSampler(LangevinSplittingDynamicsMove('V R O R
   V', 2 fs, 1/ps, 50 steps), 'swap-all') -> create -> minimize -> run(3):
   sweep mode with K2's alchemical kernel and SETTLE, K2's launches an
   iteration (9 x 51 propagation evaluations and the 81 of the energy
   matrix, each a bound and a force launch), the matrix finite, two of its
   entries against the plain sweep plus the remainder at their state's
   lambdas, u[n, s_n] against beta U of each replica's final integrator
   state, the swap counters symmetric, MBAR over the in-memory energies
   finite, the seconds an iteration split into mixing, propagation, the
   energy matrix and reporting, and K2's device ms an iteration (launch_ms
   at the path's shapes); where h5py and PyYAML import, the run writes its
   storage and the analyzer reads it back to the in-memory MBAR (rel
   1e-10); (b) single-replica SAMS ('global-jump', 6 iterations) on the
   same box and ladder: finite visits and logZ, K2's launches; (c) parallel
   tempering on LennardJonesFluid(2048), 8 temperatures from 120 to 180 K,
   LangevinDynamicsMove(5,000 steps), 'swap-neighbors', 5 iterations: one
   lj_forces and one lj_chunk launch a replica an iteration (K1), and the
   O(N) energies against each state's dense reduced potential;
15. the equilibration path: (a) run_gentle_equilibration on
   PMEWaterBox(box_edge=6.223) at 300 K, its 8,000 oxygens restrained at
   sigma 0.3 nm in stages 1-3: a restrained minimize (200 FIRE
   iterations), NVT (500 steps, 1 fs, 10/ps), NPT at 1 bar restrained and
   NPT free (500 steps each and 20 barostat attempts after), every energy
   and force through a bound integrator of the phase's context cache in
   sweep mode (the thermodynamic state's dense energy raises at this size,
   so no dense route can complete): sweep mode, K2 and SETTLE in every
   stage, the restraint among the sweep's leftover terms in stages 1-3,
   K2's launches by stage exactly (FIRE one an iteration plus its final
   energy and the acceptance check's two; a dynamics stage n_steps + 1;
   two a barostat attempt), the restrained minimum below the start, the
   rigid geometry and a finite box after every stage, the last stage's
   kinetic temperature within 5 %, one barostat attempt's two energies
   against the plain sweep plus the remainder; set-up and run seconds a
   stage, ms a barostat attempt, K2's held device ms and the float32
   trial's projection onto the constraints in it, the acceptances, the
   volume, ns/day; (b) parallel tempering on the same box
   (4 temperatures from 300 to 330 K, LangevinDynamicsMove 2 fs x 50
   steps, one iteration from a FIRE-minimized state): K2's launches 4 x
   (50 + 1) + 4 of each, the O(N) columns against the plain sweep plus
   the remainder.

Phase 1 also prints ``utils.platforms.device_report()``.

Times of the chunk kernels of K1, K3 and K4 (``ms``, ``plain_ms``,
``bound_ms`` of their entries, marked ``"per": "step"``) are per step of a
chunk.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
import collections
import json
import math
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
N = 2048
CHUNK = 50_000
TEMPERATURE = 120.0
SOURCE = "openmmtools_tpu_torch/csrc/fused_langevin.cu"
REPLACES = "openmmtools_tpu/ops/pallas_baoab.py:761"
SWEEP_SOURCE = "openmmtools_tpu_torch/csrc/sweep_nb.cu"
SWEEP_REPLACES = "openmmtools_tpu/ops/sweep_nb.py:471"
DENSE_SOURCE = "openmmtools_tpu_torch/csrc/dense_baoab.cu"
DENSE_REPLACES = "openmmtools_tpu/ops/pallas_baoab.py:296"
CELL_SOURCE = "openmmtools_tpu_torch/csrc/cell_md.cu"
CELL_REPLACES = "openmmtools_tpu/ops/pallas_md.py:503"
TIMED_STEPS = 1_000      # steps of a timed chunk (the plain version: 20)
RAGGED_N = 1_000         # a fluid whose last block of warps is ragged
CELL_N_LARGE = 16_384    # the second size of the cell-list question
WATER_EDGE = 6.223       # the JAC DHFR box: 20^3 TIP3P waters, 24,000 atoms
WATER_T = 300.0
WARMUP = 5_000
WATER_CHUNK = 1_000
REBUILD_STEPS = 1_000    # untimed water steps counting K2's rebuilds
# the H100 SXM's published peaks (NVIDIA's data sheet): 3.35 TB/s of HBM,
# 67 TFLOP/s of FP32 outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
# FP32 operations counted per pair for the bounds below: a distance test
# (3 differences, 2 wrap compares per axis, 3 squares, 2 sums, a compare)
# and the LJ + erfc/RF + switch + force accumulation of a pair inside the
# cutoff
OPS_DIST = 15
OPS_PAIR = 60
# the alchemical variant's pair inside the cutoff adds the class index (two
# compares, a multiply-add chain), three shared-memory reads, the softcore
# (a clamp, a multiply-add, a reciprocal, six products) and the lam_e
# scaling: 20 more
OPS_PAIR_ALCH = OPS_PAIR + 20
ALCH_LAMBDAS = dict(lambda_electrostatics=0.0, lambda_sterics=0.5)
# K2's kernels in their one-thread-a-slot design (the partner or shell range
# in 8 grid.y slices), timed by this script at the main paths' final states
# on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md's kernel table; the bound
# pass on a rebuild, on a fresh ring): printed beside the times of this
# checkout's kernels
K2_SLOT_A_THREAD_MS = {"sweep_forces": 1.2726, "sweep_forces_alch": 1.3896,
                       "sweep_bound": 0.6138}
ALCH_WARMUP = 2_000
NCMC_STEPS = 500
PERTURB_STEPS = 10
SMALL_EDGE = 3.0         # the box of the sweep-against-dense check: 3,000 atoms
SPLITTINGS = ("V R O R V", "O V R V O", "V R R O R R V", "V R V")
# float32 kernel against float32 plain PyTorch: the sums over ~N partners run
# in another order, and rsqrtf differs from torch.rsqrt in the last bits, so
# both agree to float32 rounding times N, well inside 2e-4 of scale -- the
# tolerance the JAX package holds its own TPU kernel to
# (tests/test_pallas_baoab.py:53-54, :195-202)
REL_TOL = 2e-4


def say(*args):
    print(*args, flush=True)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's smoke run "
                         "needs an NVIDIA GPU")
    import openmmtools_tpu_torch

    pkg = pathlib.Path(openmmtools_tpu_torch.__file__).resolve()
    if ROOT not in pkg.parents:
        raise SystemExit(f"chip_smoke: openmmtools_tpu_torch comes from {pkg},"
                         f" not from this checkout ({ROOT})")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    from openmmtools_tpu_torch.utils import device_report

    say(f"phase 1 device: {name}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} card(s)")
    say(f"phase 1 device report: {json.dumps(device_report())}")
    say(smi)
    return name, smi


def phase_build():
    from openmmtools_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build()
    _build.load_library()
    say(f"phase 2 build: {', '.join(p.name for p in paths)} in "
        f"{time.perf_counter() - t0:.2f} s")


def cuda_ms(fn, reps=200):
    """Mean ms per call over ``reps`` calls, by CUDA events, after warm-up."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class launch_events:
    """Within the block, every call of the C entry point ``entry`` records a
    CUDA event just before and just after its launch into ``pairs``: the
    device time of each launch, none of the wrapper's own torch work."""

    def __init__(self, entry):
        from openmmtools_tpu_torch.ops import _build

        self.lib = _build.load_library()
        self.entry = entry
        self.launch = getattr(self.lib, entry)
        self.pairs = []

    def timed(self, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        err = self.launch(*args)
        end.record()
        self.pairs.append((start, end))
        return err

    def __enter__(self):
        setattr(self.lib, self.entry, self.timed)
        return self

    def __exit__(self, *exc):
        setattr(self.lib, self.entry, self.launch)

    def ms(self):
        return [s.elapsed_time(e) for s, e in self.pairs]


def launch_ms(fn, entry, reps=50):
    """Mean device time (ms) of the launches of the C entry point ``entry``
    over ``reps`` calls of ``fn`` (one launch a call) after warm-up, every
    launch counted: CUDA events recorded just before and just after each
    launch. A spin kernel holds the stream while the host queues the calls,
    so the device never waits on the host between a pair of events; the
    wrapper's own torch work (small operations before the launch, which
    CUDA events around back-to-back calls would time instead) runs outside
    the pairs."""
    for _ in range(3):
        fn()
    with launch_events(entry) as rec:
        for cycles in (20_000_000, 80_000_000, 320_000_000):
            torch.cuda.synchronize()
            rec.pairs.clear()
            torch.cuda._sleep(cycles)
            held = torch.cuda.Event()
            held.record()
            for _ in range(reps):
                fn()
            queued_while_held = not held.query()
            torch.cuda.synchronize()
            if queued_while_held:
                break
        else:
            raise AssertionError(f"{entry}: the host did not queue {reps} "
                                 "calls within the spin kernel")
    assert len(rec.pairs) == reps, (entry, len(rec.pairs))
    return sum(rec.ms()) / reps


def max_rel(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


def wrapped_dx(a, b, L):
    d = (torch.remainder(a, L) - torch.remainder(b, L)).abs()
    return float(torch.minimum(d, (d - L).abs()).max())


def fluid_program(fluid, tokens="V R O R V", collision_rate=1.0):
    from openmmtools_tpu_torch.ops.fused_langevin import FusedSortedLangevin

    t = fluid.system.terms[0]
    return FusedSortedLangevin(
        fluid.n_particles, t.cutoff, t.switch_width, float(t.sigma[0]),
        float(t.epsilon[0]), float(fluid.system.masses[0]), 0.002,
        collision_rate, tokens=tuple(tokens.split()))


def phase_kernels(dev):
    from openmmtools_tpu_torch.constants import kB
    from openmmtools_tpu_torch.integrators import fire_minimize
    from openmmtools_tpu_torch.models import LennardJonesFluid
    from openmmtools_tpu_torch.ops.fused_langevin import (
        fused_langevin_reference,
        lj_forces_reference,
    )

    fluid = LennardJonesFluid(nparticles=N, device=dev)
    prog = fluid_program(fluid)
    xT = fluid.positions.t().contiguous()
    L = torch.diagonal(fluid.system.default_box).contiguous()
    kT = torch.tensor([kB * TEMPERATURE], device=dev)

    F, U = prog.forces(xT, L)
    F_ref, U_ref = lj_forces_reference(xT, L, **prog._physics())
    torch.cuda.synchronize()
    f_err = float((F - F_ref).abs().max())
    f_rel, u_rel = max_rel(F, F_ref), abs(float(U[0] - U_ref)) / abs(float(U_ref))
    say(f"phase 3 lj_forces N={N}: max|dF| {f_err:.3e} (rel {f_rel:.2e}), "
        f"U {float(U[0]):.6f} vs plain {float(U_ref):.6f} (rel {u_rel:.2e})")
    assert f_rel <= REL_TOL and u_rel <= REL_TOL, (f_rel, u_rel)

    # the chunk kernel, one launch a chunk, against the plain chunk: every
    # splitting, a two-sweep one among them, with noise off and on, at N and
    # at a ragged N (a FIRE-minimized start there: the raw Sobol start at a
    # ragged N holds a clash that makes 40 steps chaotic at float32 rounding)
    ragged = LennardJonesFluid(nparticles=RAGGED_N, device=dev)
    ragged.positions, _ = fire_minimize(ragged.system, ragged.positions,
                                        ragged.system.default_box,
                                        max_steps=200)
    chunk_err = 0.0
    for fl in (fluid, ragged):
        n = fl.n_particles
        box = fl.system.default_box
        v0 = thermal(n, dev, 1)
        for gamma in (0.0, 1.0):
            for splitting in SPLITTINGS + ("R V R V",):
                p = fluid_program(fl, splitting, gamma)
                out = p.chunk(fl.positions, v0, box, kT, 4242, 40)
                ref = fused_langevin_reference(p, fl.positions, v0, box, kT,
                                               4242, 40)
                dx = wrapped_dx(out[0], ref[0], float(box[0, 0]))
                dv = float((out[1] - ref[1]).abs().max())
                v_scale = float(ref[1].abs().max())
                du = abs(float(out[3] - ref[3])) / abs(float(ref[3]))
                say(f"phase 3 chunk N={n} gamma={gamma} '{splitting}' 40 "
                    f"steps, launches {p.launches}: dx {dx:.2e} dv/v "
                    f"{dv / v_scale:.2e} dU/U {du:.2e}")
                assert p.launches == {"lj_forces": 0, "lj_chunk": 1}
                assert dx < 5e-4 and dv < 5e-3 * v_scale and du <= REL_TOL, (
                    n, splitting, gamma, dx, dv, du)
                chunk_err = max(chunk_err, dx)
    return dict(prog=prog, xT=xT, L=L, kT=kT, f_err=f_err,
                chunk_err=chunk_err, v=thermal(N, dev, 1))


def phase_noise(dev):
    from openmmtools_tpu_torch.integrators import BAOABIntegrator
    from openmmtools_tpu_torch.models import LennardJonesFluid
    from openmmtools_tpu_torch.system import instantaneous_temperature

    fluid = LennardJonesFluid(nparticles=N, device=dev)
    bound = BAOABIntegrator(temperature=TEMPERATURE, collision_rate=1.0,
                            timestep=0.002).bind(fluid.system)
    assert bound._fused is not None, "the fused path did not engage on CUDA"
    state = bound.initial_state(fluid.sampler_state(),
                                torch.Generator().manual_seed(3),
                                temperature=TEMPERATURE)
    state = bound.run(state, 1000)
    temps = []
    for _ in range(50):
        state = bound.run(state, 100)
        temps.append(float(instantaneous_temperature(fluid.system.masses,
                                                     state.velocities)))
    mean_t = statistics.fmean(temps)
    say(f"phase 4 noise: mean kinetic temperature {mean_t:.3f} K over "
        f"{len(temps)} samples 100 steps apart (target {TEMPERATURE} K, "
        f"sd {statistics.stdev(temps):.3f} K)")
    assert abs(mean_t - TEMPERATURE) < 0.05 * TEMPERATURE


def phase_main_path(dev, smi, k):
    from openmmtools_tpu_torch.integrators import BAOABIntegrator
    from openmmtools_tpu_torch.models import LennardJonesFluid
    from openmmtools_tpu_torch.ops.fused_langevin import (
        fused_langevin_reference,
        lj_forces_reference,
    )
    from openmmtools_tpu_torch.system import make_energy_force_fn

    fluid = LennardJonesFluid(nparticles=N, device=dev)
    integ = BAOABIntegrator(temperature=TEMPERATURE, collision_rate=1.0,
                            timestep=0.002)
    bound = integ.bind(fluid.system)
    fused = bound._fused
    assert fused is not None, "the fused path did not engage on CUDA"
    for key in fused.launches:
        fused.launches[key] = 0
    state = bound.initial_state(fluid.sampler_state(),
                                torch.Generator().manual_seed(0),
                                temperature=TEMPERATURE)
    state = bound.run(state, CHUNK)  # warm-up
    torch.cuda.synchronize()
    rates, busy = [], []
    t0 = time.perf_counter()
    # the chunk kernel's device time against each chunk's wall time: how
    # much of a chunk the host holds the card idle
    with launch_events("lj_chunk_f32") as rec:
        while time.perf_counter() - t0 < 8.0 and len(rates) < 12:
            tc = time.perf_counter()
            state = bound.run(state, CHUNK)
            positions = state.positions.cpu().numpy()
            wall = time.perf_counter() - tc
            rates.append(CHUNK / wall)
            busy.append(rec.ms()[-1] / (1e3 * wall))
            assert positions.shape == (N, 3)
            assert bool((positions == positions).all()), "non-finite positions"
    launches = dict(fused.launches)
    chunks = 1 + len(rates)
    steps = CHUNK * chunks
    say(f"phase 5 main path: {steps} steps in {chunks} chunks; launches "
        f"{launches} ({launches['lj_chunk'] / chunks:.0f} a chunk; lj_forces "
        f"the initial state's F and U)")
    for kernel, count in launches.items():
        assert count > 0, f"{kernel} never launched on the main path"
    assert launches == {"lj_forces": 1, "lj_chunk": chunks}, launches

    # the output is right: finite, and its energy and forces agree with the
    # port's own dense analytic evaluation of the final positions
    x = state.positions
    assert torch.isfinite(x).all() and torch.isfinite(state.velocities).all()
    u_ref, f_ref = make_energy_force_fn(fluid.system)(x)
    u_rel = abs(float(state.potentials[0] - u_ref)) / abs(float(u_ref))
    f_rel = max_rel(state.forces[0], f_ref)
    say(f"phase 5 final state: U {float(state.potentials[0]):.4f} vs dense "
        f"{float(u_ref):.4f} (rel {u_rel:.2e}), forces rel {f_rel:.2e}")
    assert u_rel <= REL_TOL and f_rel <= REL_TOL

    best, median = max(rates), statistics.median(rates)
    say(f"phase 5 throughput: {best:.1f} steps/s max, {median:.1f} median "
        f"({len(rates)} timed chunks of {CHUNK}); the chunk kernel busy "
        f"{min(busy):.4f}-{max(busy):.4f} of a chunk's wall time (median "
        f"{statistics.median(busy):.4f}) on {smi}")

    # kernel and plain times at the main path's shapes, in turns: one force
    # evaluation, and a step of a TIMED_STEPS chunk (plain: 20 steps)
    prog, xT, L, kT = k["prog"], k["xT"], k["L"], k["kT"]
    physics = prog._physics()
    box = fluid.system.default_box
    v = k["v"]
    x0 = fluid.positions
    times = {}
    for label, fn, per in (
            ("plain_f", lambda: lj_forces_reference(xT, L, **physics), 1),
            ("kernel_f", (lambda: prog.forces(xT, L), "lj_forces_f32"), 1),
            ("kernel_f2", (lambda: prog.forces(xT, L), "lj_forces_f32"), 1),
            ("plain_f2", lambda: lj_forces_reference(xT, L, **physics), 1),
            ("plain_c", lambda: fused_langevin_reference(
                prog, x0, v, box, kT, 5, 20), 20),
            ("kernel_c", (lambda: prog.chunk(x0, v, box, kT, 5, TIMED_STEPS),
                          "lj_chunk_f32"), TIMED_STEPS),
            ("kernel_c2", (lambda: prog.chunk(x0, v, box, kT, 5, TIMED_STEPS),
                           "lj_chunk_f32"), TIMED_STEPS),
            ("plain_c2", lambda: fused_langevin_reference(
                prog, x0, v, box, kT, 5, 20), 20)):
        if isinstance(fn, tuple):
            times[label] = launch_ms(*fn, reps=20 if per == 1 else 3) / per
        else:
            times[label] = cuda_ms(fn, reps=200 if per == 1 else 2) / per
    f_ms = min(times["kernel_f"], times["kernel_f2"])
    f_plain = min(times["plain_f"], times["plain_f2"])
    c_ms = min(times["kernel_c"], times["kernel_c2"])
    c_plain = min(times["plain_c"], times["plain_c2"])
    say(f"phase 5 one force evaluation N={N} (device): kernel {f_ms:.5f} ms, "
        f"plain {f_plain:.4f} ms; a step of a {TIMED_STEPS}-step chunk "
        f"(device): kernel {c_ms:.5f} ms, plain {c_plain:.4f} ms (20-step "
        f"chunk) ({smi})")
    # where a step goes: "R V R V" runs two sweeps and three segments a step
    # where "V R O R V" runs one and two, so the difference is a sweep with
    # its grid barrier and a segment
    two = fluid_program(fluid, "R V R V")
    two_ms = launch_ms(lambda: two.chunk(x0, v, box, kT, 5, TIMED_STEPS),
                       "lj_chunk_f32", reps=3) / TIMED_STEPS
    say(f"phase 5 a step of 'R V R V' (two sweeps): {two_ms:.5f} ms; so a "
        f"sweep with its grid barrier and a segment {two_ms - c_ms:.5f} ms, "
        f"a segment with the step's own work {2 * c_ms - two_ms:.5f} ms "
        f"({smi})")
    # bounds from this run's inputs: the forces need each of the N(N-1)/2
    # pairs tested once and each pair inside the cutoff evaluated once
    # (Newton's third law; the kernel meets each pair from both ends); a
    # chunk of n steps needs n * sweeps + 1 such evaluations and reads x, v,
    # F and writes x, v a step
    n_tests, n_in = lj_pair_counts(xT, L, prog.rc)
    f_bound = bound_ms(4 * (3 * N + 3 + 3 * N + 1),
                       n_tests * OPS_DIST + n_in * OPS_PAIR)
    c_bound = chunk_bound_ms(prog, TIMED_STEPS, n_tests, n_in)
    say(f"phase 5 bounds: lj_forces {f_bound[0]:.6f} ms by {f_bound[1]} "
        f"({n_tests} pair tests, {n_in} pairs inside the cutoff), lj_chunk "
        f"{c_bound[0]:.6f} ms a step by {c_bound[1]}")
    return [
        dict(name="lj_forces", route="cuda", source=SOURCE, replaces=REPLACES,
             launches=launches["lj_forces"], max_abs_err=k["f_err"],
             ms=f_ms, plain_ms=f_plain, bound_ms=f_bound[0],
             bound_by=f_bound[1], library_ms=None),
        dict(name="lj_chunk", route="cuda", source=DENSE_SOURCE,
             replaces=REPLACES, launches=launches["lj_chunk"],
             max_abs_err=k["chunk_err"], ms=c_ms, plain_ms=c_plain,
             bound_ms=c_bound[0], bound_by=c_bound[1], library_ms=None,
             per="step"),
    ], dict(steps_per_s_max=best, steps_per_s_median=median,
            chunk_busy_median=statistics.median(busy), step_ms=c_ms,
            two_sweep_step_ms=two_ms, forces_ms=f_ms)


def chunk_bound_ms(prog, steps, n_tests, n_in):
    """The bound of one step of a ``steps``-step chunk of ``prog`` (ms, and
    what bounds it): steps x (sweeps a step) + 1 all-pairs evaluations at
    these pairs, and the segments' bytes (x, v, F read, x, v written a
    step), divided by the steps."""
    sweeps = [item[0] for item in prog.program].count("sweep")
    evaluations = steps * sweeps + 1
    ms, by = bound_ms(
        evaluations * 4 * (3 * N + 3 + 3 * N + 1) + steps * 4 * (5 * 3 * N + 4),
        evaluations * (n_tests * OPS_DIST + n_in * OPS_PAIR))
    return ms / steps, by


def lj_pair_counts(xT, L, rc):
    """The pairs an all-pairs LJ evaluation of (3, N) positions needs, each
    once: N(N-1)/2 tested, and those inside the cutoff (minimum image)."""
    n = xT.shape[1]
    d2 = sum((xT[c][:, None] - xT[c][None, :]
              - L[c] * torch.round((xT[c][:, None] - xT[c][None, :]) / L[c])
              ) ** 2 for c in range(3))
    return n * (n - 1) // 2, int(((d2 < rc ** 2) & (d2 > 1e-12)).sum()) // 2


def bound_ms(n_bytes, n_ops):
    """The least time of a kernel on the card (ms): the larger of its bytes
    over the memory rate and its FP32 operations over the FP32 peak, and
    which of the two it is."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_FP32
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# the explicit-solvent path: K2 (the bounded sweep) and sweep mode
# ---------------------------------------------------------------------------


def sweep_pairs(xT, L, k, S):
    """The slot pairs (i, i + s), s = 1..S, of real slots, and those inside
    the cutoff: each pair of the window once (the shell s = n_pad/2 meets
    its pairs from both ends and counts half), counted in chunks."""
    from openmmtools_tpu_torch.ops import sweep_nb as tsw

    o = torch.arange(1, S + 1, device=xT.device)
    weight = torch.where(o == k.n_pad // 2, 0.5, 1.0)
    tested = inside = 0.0
    rows = max(1, (1 << 22) // o.shape[0])
    for i0 in range(0, k.n, rows):
        i = torch.arange(i0, min(i0 + rows, k.n), device=xT.device)[:, None]
        j = (i + o[None, :]) % k.n_pad
        _, r2 = tsw._pair_r2(xT, L, i, j)
        real = j < k.n
        tested += float((real * weight).sum())
        inside += float(((real & (r2 < k.rc * k.rc) & (r2 > 1e-12))
                         * weight).sum())
    return tested, inside


def queue_drains(xT, L, k, S):
    """What K2's force kernel queues on these inputs: each real slot's window
    partners i +- s, s <= S, inside the cutoff (exception pairs too: their
    bits are read at the drain), drained 32 at a time. Returns the mean
    pairs queued a slot, full drains a slot, and the share of slots that
    end in a partial drain."""
    from openmmtools_tpu_torch.ops import sweep_nb as tsw

    o = torch.cat([torch.arange(-S, 0, device=xT.device),
                   torch.arange(1, S + 1, device=xT.device)])
    rows = max(1, (1 << 22) // max(1, o.shape[0]))
    hits = []
    for i0 in range(0, k.n, rows):
        i = torch.arange(i0, min(i0 + rows, k.n), device=xT.device)[:, None]
        j = (i + o[None, :]) % k.n_pad
        _, r2 = tsw._pair_r2(xT, L, i, j)
        hits.append(((j < k.n) & (r2 < k.rc * k.rc) & (r2 > 1e-12)).sum(1))
    h = torch.cat(hits).double()
    return (float(h.mean()), float(torch.floor(h / 32).mean()),
            float((h % 32 > 0).double().mean()))


def phase_sweep_kernels(dev):
    from openmmtools_tpu_torch.models import PMEWaterBox
    from openmmtools_tpu_torch.ops import sweep_nb as tsw

    w = PMEWaterBox(box_edge=WATER_EDGE, device=dev)
    term = w.system.terms[0]
    n = w.system.n_particles
    mask_shells = min(2048, max(32, (-(-n // 128) * 128 // 2 // 32) * 32))
    worst = dict(f=0.0, nb=0)
    for label, method, swc in (("pme, LJ switch", "pme", False),
                               ("reaction field", "cutoff_periodic", False),
                               ("pme, Coulomb switch", "pme", True)):
        k = tsw.SweepNonbonded(
            n, method, term.cutoff, switch_width=term.switch_width,
            ewald_alpha=term.ewald_alpha if method == "pme" else None,
            switch_coulomb=swc, mask_shells=mask_shells)
        xT, par, excl, L, max_sep = tsw.sorted_inputs(term, w.positions,
                                                      w.system.default_box, k)
        assert int(max_sep) <= k.mask_shells
        nb_in = torch.zeros((), dtype=torch.int32, device=dev)
        for rebuild in (True, False):
            flag = torch.tensor(rebuild, device=dev)
            nb = k.measure_bound(xT, L, flag, nb_in)
            nb2 = k.measure_bound(xT, L, flag, nb_in)
            nb_ref = tsw.measure_bound_reference(
                xT, L, flag, nb_in, n=k.n, cutoff=k.rc, skin=k.skin,
                shell_block=k.bs)
            F, U = k.sweep(xT, par, excl, L, nb)
            F2, U2 = k.sweep(xT, par, excl, L, nb)
            F_ref, U_ref = tsw.sweep_forces_reference(xT, par, excl, L,
                                                      nb_ref, **k.physics())
            torch.cuda.synchronize()
            f_err = float((F - F_ref).abs().max())
            f_rel, u_rel = max_rel(F, F_ref), abs(float(U - U_ref)) / abs(
                float(U_ref))
            same = torch.equal(F, F2) and torch.equal(U, U2)
            say(f"phase 6 sweep {label}, rebuild {rebuild}: bound "
                f"{int(nb)} (a second launch {int(nb2)}) vs plain "
                f"{int(nb_ref)}, max|dF| {f_err:.3e} "
                f"(rel {f_rel:.2e}), U {float(U):.4f} vs plain "
                f"{float(U_ref):.4f} (rel {u_rel:.2e}); a second launch "
                f"gives the same bits: {same}")
            assert int(nb) == int(nb2) == int(nb_ref), (label, rebuild)
            assert f_rel <= REL_TOL and u_rel <= REL_TOL, (label, f_rel, u_rel)
            assert same, (label, rebuild)
            worst["f"] = max(worst["f"], f_err)
            worst["nb"] = max(worst["nb"], abs(int(nb) - int(nb_ref)))
            nb_in = nb.reshape(()).clone()   # pass the bound through next
    assert k.launches == {"sweep_bound": 4, "sweep_forces": 4}
    return worst


def kinetic_temperature(masses, v, dof):
    from openmmtools_tpu_torch.constants import kB

    return float(torch.sum(masses[:, None] * v * v)) / (dof * kB)


def profile_steps(bound, state, n_steps, phase="phase 7"):
    """torch.profiler over ``n_steps`` steps with the step's parts marked:
    K2 (the sweep wrapper and its kernels), SETTLE on positions and on
    velocities, the PME structure-factor einsums forward and backward, and
    the rest of the remainder (bonded terms, exception add-back, PME's other
    terms, forward and autograd backward). Returns the state, the profiled
    wall ms per step, the device's busy ms per step, per part (device ms,
    host ms) per step, and the busiest kernels.

    Each device activity goes to the innermost marked range that was open on
    the host when it was launched: the launch's runtime call, found by its
    correlation id, or else the operator it is linked to. "other" holds what
    falls in no range (the integrator's updates, the sort and its gathers)."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    import openmmtools_tpu_torch.integrators.langevin as lg
    from openmmtools_tpu_torch.ops import pme as tpme

    marks = {"K2 sweep": (bound._sweep_kernel, "evaluate"),
             "SETTLE positions": (bound, "_constrain_positions"),
             "SETTLE velocities": (bound, "_constrain_velocities"),
             "PME einsums, forward": (tpme, "_sf_forward_real"),
             "PME einsums, backward": (tpme, "_sf_real_backward"),
             "remainder, rest (fwd + bwd)": (lg, "value_and_grad")}
    originals = {}
    for label, (obj, name) in marks.items():
        fn = getattr(obj, name)
        # (the function, whether obj itself held it or its class did)
        originals[label] = (fn, name in vars(obj))

        def marked(*a, _fn=fn, _label=label, **kw):
            with record_function(_label):
                return _fn(*a, **kw)
        setattr(obj, name, marked)
    try:
        state = bound.run(state, 10)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state = bound.run(state, n_steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for label, (obj, name) in marks.items():
            fn, own = originals[label]
            if own:
                setattr(obj, name, fn)
            else:
                delattr(obj, name)

    events = prof.profiler.kineto_results.events()
    # device work: kernels, copies and fills (the marked ranges also show on
    # the device as spans, which are not work)
    work = [e for e in events
            if e.device_type() == DeviceType.CUDA and e.name() not in marks]
    busy_ns = sum(e.duration_ns() for e in work)
    host_events = [e for e in events if e.device_type() == DeviceType.CPU]
    ranges = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
              for e in host_events if e.name() in marks]
    # the runtime's launch calls (cudaLaunchKernel, cuLaunchKernelEx,
    # cudaMemcpyAsync, ...) carry the correlation id of the device activity
    # they start; operators and ranges carry ids of their own
    host_ops = {}
    launches = {}
    for e in host_events:
        table = launches if e.name().startswith("cu") else host_ops
        table[e.correlation_id()] = e.start_ns()

    def part_at(t):
        inner = None
        for lo, hi, name in ranges:
            if lo <= t <= hi and (inner is None or hi - lo < inner[0]):
                inner = (hi - lo, name)
        return "other" if inner is None else inner[1]

    device = defaultdict(float)
    by_name = defaultdict(float)
    linked = 0
    for e in work:
        t = launches.get(e.correlation_id(),
                         host_ops.get(e.linked_correlation_id()))
        linked += t is not None
        device["other" if t is None else part_at(t)] += e.duration_ns()
        by_name[e.name()[:60]] += e.duration_ns()
    host = defaultdict(float)
    for lo, hi, name in ranges:
        host[name] += hi - lo
    per_step = 1e6 * n_steps
    parts = {label: (device[label] / per_step, host[label] / per_step)
             for label in list(marks) + ["other"]}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    say(f"{phase} profile: {len(work)} device activities, {linked} traced to "
        f"their launch")
    return (state, 1e3 * wall / n_steps, busy_ns / per_step, parts,
            [(name, ns / per_step) for name, ns in top])


def run_timed(bound, state, warmup, system, dof, label,
              temperature_last=False):
    """Warm-up, 20 kinetic-temperature samples 50 steps apart (the mean
    within 5 % of the target), and 1,000-step chunks (at least 3, up to 20
    s), each ending in a host fetch of the positions; the samples before the
    chunks, or after them with ``temperature_last``. Returns the state, the
    chunks' steps/s and the steps run."""
    n = system.n_particles
    tw = time.perf_counter()
    state = bound.run(state, warmup)
    torch.cuda.synchronize()
    say(f"{label} warm-up: {warmup} steps in {time.perf_counter() - tw:.2f} s")

    def temperature(state):
        temps = []
        for _ in range(20):
            state = bound.run(state, 50)
            temps.append(kinetic_temperature(system.masses, state.velocities,
                                             dof))
        mean_t = statistics.fmean(temps)
        say(f"{label} kinetic temperature: {mean_t:.3f} K over 20 samples 50 "
            f"steps apart ({dof} degrees of freedom; sd "
            f"{statistics.stdev(temps):.3f} K)")
        assert abs(mean_t - WATER_T) < 0.05 * WATER_T
        return state

    if not temperature_last:
        state = temperature(state)
    rates = []
    tc0 = time.perf_counter()
    while len(rates) < 3 or (time.perf_counter() - tc0 < 20.0
                             and len(rates) < 10):
        tc = time.perf_counter()
        state = bound.run(state, WATER_CHUNK)
        positions = state.positions.cpu().numpy()
        rates.append(WATER_CHUNK / (time.perf_counter() - tc))
        assert positions.shape == (n, 3)
    if temperature_last:
        state = temperature(state)
    return state, rates, warmup + 20 * 50 + WATER_CHUNK * len(rates)


def count_rebuilds(bound, state, k, n_steps):
    """``n_steps`` untimed steps of ``bound`` with each call of K2's
    ``measure_bound`` recording its rebuild flag on the device and the ring
    it was given; returns the state, the launches with the flag set, all
    launches, and the path's own ring at its last rebuild before a re-sort
    (``n_steps`` is a multiple of the sort interval) with the steps since
    the sort that made it."""
    measure = k.measure_bound
    interval = bound.sweep_sort_interval
    flags = []
    rings = collections.deque(maxlen=interval)

    def recording(xT, L, rebuild, nblk):
        flags.append(torch.as_tensor(rebuild, device=xT.device).reshape(()))
        rings.append(xT)
        return measure(xT, L, rebuild, nblk)

    before = k.launches["sweep_bound"]
    k.measure_bound = recording
    state = bound.run(state, n_steps)
    del k.measure_bound
    calls = k.launches["sweep_bound"] - before
    assert calls == len(flags) == n_steps and n_steps % interval == 0, (
        calls, len(flags))
    flags = torch.stack(flags)
    # the last sort interval's last evaluation with the flag set
    last = int(torch.nonzero(flags[-interval:]).max())
    return state, int(flags.sum()), calls, rings[last], last + 1


def path_ring(bound, state):
    """The ring that the path's evaluations read at ``state``: its positions
    wrapped and gathered through the state's sweep order (made at the last
    re-sort), (3, n_pad) float32, with the box's edges."""
    from openmmtools_tpu_torch.ops import sweep_nb as tsw

    k = bound._sweep_kernel
    box = state.box if state.box is not None else bound.system.default_box
    _, xT = tsw.sorted_positions(state.positions, box,
                                 state.sweep_perm.long(), k.n_pad,
                                 torch.float32)
    return xT, torch.diagonal(box).to(torch.float32).contiguous()


def same_bound(k, plain, xT, L, label):
    """K2's bound on a rebuild at ``xT``, launched twice, against the plain
    version: the same int (these launches are not the path's)."""
    before = dict(k.launches)
    flag = torch.tensor(True, device=xT.device)
    zero = torch.zeros((), dtype=torch.int32, device=xT.device)
    got = [int(k.measure_bound(xT, L, flag, zero)) for _ in range(2)]
    want = int(plain.measure_bound(xT, L, flag, zero))
    k.launches.update(before)
    say(f"{label}: sweep_bound {got[0]} (a second launch {got[1]}) vs plain "
        f"{want} blocks of {k.n_blocks}")
    assert got[0] == got[1] == want, (label, got, want)
    return want


def x_window_pairs(xT, L, k):
    """The pairs (i, i + s), s = 1..n_pad/2, of real slots within w = rc +
    skin of each other in x (minimum image), each once (the shell n_pad/2
    meets its pairs from both ends and counts half): the distance tests
    that the bound needs on this ring, since no pair farther apart in x can
    lie within w."""
    from openmmtools_tpu_torch.ops import sweep_nb as tsw

    half = k.n_pad // 2
    s = torch.arange(1, half + 1, device=xT.device)
    weight = torch.where(s == half, 0.5, 1.0)
    w = k.rc + k.skin
    count = 0.0
    rows = max(1, (1 << 22) // half)
    for i0 in range(0, k.n, rows):
        i = torch.arange(i0, min(i0 + rows, k.n), device=xT.device)[:, None]
        j = (i + s[None, :]) % k.n_pad
        dx = tsw._ring_delta(xT[0][i] - xT[0][j], L[0])
        count += float((((j < k.n) & (dx.abs() <= w)) * weight).sum())
    return count


def bound_floor_tests(xT, L, k, nb):
    """The distance tests that K2's bound kernel cannot skip on this ring,
    whose bound is ``nb``: each group of 32 slots tests every partner tile
    that its cull (``far_tiles``) keeps and whose largest shell lies in a
    block above the bound's last one, since no best found in any order of
    the warps reaches that block; 32 x 32 tests a tile. The tile that finds
    the best hit and the cull's own decisions are left out, so the count is
    a floor for any order of the scan."""
    from openmmtools_tpu_torch.ops import sweep_nb as tsw

    far = tsw.far_tiles(xT, L, k.n, k.rc, k.skin)
    tiles, half = far.shape[0], k.n_pad // 2
    kk = torch.arange(half // 32 + 1, device=far.device)
    top = (torch.clamp(32 * kk + 31, max=half) - 1) // k.bs
    g = torch.arange(tiles, device=far.device)[:, None]
    keep = ~far[g, (g + kk[None, :]) % tiles] & (top > nb - 1)[None, :]
    return 32 * 32 * int(keep.sum())


def check_final_state(bound, state, label):
    """The output is right: finite, rigid, and the run's own final energy
    and forces agree with the plain sweep plus the remainder at the same
    positions (a fresh sort and a full rebuild). Returns the plain
    oracle."""
    from openmmtools_tpu_torch.ops import sweep_nb as tsw

    system = bound.system
    k = bound._sweep_kernel
    x = state.positions
    assert torch.isfinite(x).all() and torch.isfinite(state.velocities).all()
    c = system.constraints
    i, j = c.index[:, 0].long(), c.index[:, 1].long()
    L = torch.diagonal(system.default_box)
    d = x[i] - x[j]
    d = d - L * torch.round(d / L)
    geom = float(((torch.linalg.norm(d, dim=1) - c.distance)
                  / c.distance).abs().max())
    say(f"{label} SETTLE: max relative bond-length error {geom:.2e}")
    assert geom <= 1e-5
    sw = bound._sweep_dict(bound._resort_sweep(state))
    plain = tsw.PlainSweepNonbonded.like(k)
    bound._sweep_kernel = plain
    try:
        u_p, f_p, _ = bound._sweep_eval(x, state.box, state.global_params, sw)
    finally:
        bound._sweep_kernel = k
    u_run, f_run = state.potentials[0], state.forces[0]
    u_rel = abs(float(u_run - u_p)) / abs(float(u_p))
    f_rel = max_rel(f_run, f_p)
    say(f"{label} final state: U {float(u_run):.3f} vs plain {float(u_p):.3f} "
        f"(rel {u_rel:.2e}), forces rel {f_rel:.2e}")
    assert u_rel <= REL_TOL and f_rel <= REL_TOL
    return plain


def phase_water(dev, smi, k6):
    from openmmtools_tpu_torch.integrators import BAOABIntegrator
    from openmmtools_tpu_torch.models import PMEWaterBox
    from openmmtools_tpu_torch.ops import sweep_nb as tsw
    from openmmtools_tpu_torch.system import value_and_grad

    t0 = time.perf_counter()
    w = PMEWaterBox(box_edge=WATER_EDGE, device=dev)
    system = w.system
    n = system.n_particles
    bound = BAOABIntegrator(temperature=WATER_T, collision_rate=1.0,
                            timestep=0.002).bind(system)
    t_setup = time.perf_counter() - t0
    assert bound.sweep_mode, "sweep mode did not engage on CUDA"
    assert bound._fused is None, "the fused LJ kernel took the water box"
    assert bound._rest_constraints is None
    assert 3 * bound._settle.a.shape[0] == system.constraints.n_constraints \
        == n == 24000
    k = bound._sweep_kernel
    dof = 3 * n - system.constraints.n_constraints
    say(f"phase 7 setup: {n} atoms, {bound._settle.a.shape[0]} SETTLE "
        f"waters, n_pad {k.n_pad}, mask_rows {k.mask_rows}, PME kmax "
        f"{system.terms[1].kmax}, alpha {system.terms[1].alpha:.4f}; built "
        f"and bound in {t_setup:.2f} s")

    for key in k.launches:
        k.launches[key] = 0
    state = bound.initial_state(w.sampler_state(),
                                torch.Generator(device=dev).manual_seed(0))
    state, rates, steps = run_timed(bound, state, WARMUP, system, dof,
                                    "phase 7")
    launches = dict(k.launches)
    say(f"phase 7 main path: {steps} steps; launches {launches}")
    for kernel, count in launches.items():
        assert count > 0, f"{kernel} never launched on the main path"
    best, median = max(rates), statistics.median(rates)
    ns_day = median * 0.002 * 86400 / 1e3
    say(f"phase 7 throughput: {best:.1f} steps/s max, {median:.1f} median "
        f"({len(rates)} timed chunks of {WATER_CHUNK}), {ns_day:.2f} ns/day "
        f"at 2 fs, on {smi}")
    x = state.positions
    plain = check_final_state(bound, state, "phase 7")

    # K2 and PME at the main path's final state, in turns with the plain
    # versions; the bound kernel timed on a rebuild (its real work)
    xT, par, excl, L, _ = tsw.sorted_inputs(system.terms[0], x,
                                            system.default_box, k)
    flag = torch.tensor(True, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    same_bound(k, plain, xT, L, "phase 7 the final state, fresh ring")
    nb = k.measure_bound(xT, L, flag, zero)
    S = min(int(nb) * k.bs, k.n_pad // 2)
    f_kernel = lambda: k.sweep(xT, par, excl, L, nb)  # noqa: E731
    f_plain = lambda: plain.sweep(xT, par, excl, L, nb)  # noqa: E731
    b_kernel = lambda: k.measure_bound(xT, L, flag, zero)  # noqa: E731
    recip = system.terms[1]
    box = system.default_box
    pme = lambda: value_and_grad(  # noqa: E731
        lambda xx: recip.energy_without_exclusions(xx, box), x)
    before = dict(k.launches)
    t = {}
    for label, fn, reps in (("plain_f", f_plain, 5), ("kernel_f", f_kernel, 50),
                            ("kernel_f2", f_kernel, 50), ("plain_f2", f_plain, 5),
                            ("kernel_b", b_kernel, 20),
                            ("kernel_b2", b_kernel, 20),
                            ("pme", pme, 20), ("pme2", pme, 20)):
        # the kernels by their launches' device time (their wrappers' host
        # work would show once a kernel is faster than it)
        entry = {"kernel_f": "sweep_forces_f32",
                 "kernel_b": "sweep_bound_f32"}.get(label[:8])
        t[label] = (launch_ms(fn, entry, reps=reps) if entry
                    else cuda_ms(fn, reps=reps))
    for key in k.launches:   # the comparisons' launches are not the path's
        k.launches[key] = before[key]
    f_ms, f_plain_ms = min(t["kernel_f"], t["kernel_f2"]), min(
        t["plain_f"], t["plain_f2"])
    b_ms = min(t["kernel_b"], t["kernel_b2"])
    pme_ms = min(t["pme"], t["pme2"])
    # bounds from this run's inputs, each pair of the window once (the
    # kernel meets each pair of the force sweep from both ends): the force
    # sweep tests the pairs within S shells and evaluates those inside the
    # cutoff; the bound pass needs the tile tests that its scan cannot skip
    # (the pairs within w in x, and the whole ring's, the first design's
    # work, beside them)
    tested, inside = sweep_pairs(xT, L, k, S)
    half_tested, _ = sweep_pairs(xT, L, k, k.n_pad // 2)
    window = x_window_pairs(xT, L, k)
    floor = bound_floor_tests(xT, L, k, int(nb))
    in_bytes = 4 * (3 * k.n_pad + 3 * k.n_pad + k.mask_rows * k.n_pad + 3 + 1)
    f_bound = bound_ms(in_bytes + 4 * (3 * k.n_pad + 1),
                       tested * OPS_DIST + inside * OPS_PAIR)
    b_bytes = 4 * (3 * k.n_pad + 3 + 2 + 1)
    b_bound = bound_ms(b_bytes, floor * OPS_DIST)
    b_window = bound_ms(b_bytes, window * OPS_DIST)
    b_whole = bound_ms(b_bytes, half_tested * OPS_DIST)
    assert b_ms >= b_bound[0], (b_ms, b_bound)
    say(f"phase 7 K2 at the final state (bound {int(nb)} blocks, S = {S} "
        f"shells): sweep_forces kernel {f_ms:.4f} ms device (one thread a "
        f"slot: {K2_SLOT_A_THREAD_MS['sweep_forces']} ms), plain "
        f"{f_plain_ms:.4f} ms, bound {f_bound[0]:.4f} ms by {f_bound[1]} "
        f"({tested:.0f} pair tests, {inside:.0f} pairs inside the cutoff); "
        f"sweep_bound on a rebuild, fresh ring: kernel {b_ms:.5f} ms device "
        f"(one thread a slot: {K2_SLOT_A_THREAD_MS['sweep_bound']} ms), "
        f"bound {b_bound[0]:.6f} ms by {b_bound[1]} ({floor} tile tests "
        f"its scan cannot skip; the {window:.0f} pairs within w in x "
        f"{b_window[0]:.5f} ms, the whole ring's {half_tested:.0f} "
        f"{b_whole[0]:.4f} ms); "
        f"PME reciprocal energy + forces {pme_ms:.4f} ms a call back to back "
        f"(host-bound; its device time is in the profile below) ({smi})")

    queued, drains, partial = queue_drains(xT, L, k, S)
    # the same window at a cutoff that holds no pair: every distance test,
    # ballot and queue write, and no drain; the rest of f_ms is the drains
    no_pairs = tsw.SweepNonbonded(
        k.n, k.method, 0.05, ewald_alpha=k.alpha, mask_shells=k.mask_shells)
    tests_ms = launch_ms(lambda: no_pairs.sweep(xT, par, excl, L, nb),
                         "sweep_forces_f32", reps=50)
    say(f"phase 7 K2 force kernel's queue at the final state: {queued:.1f} "
        f"pairs inside the cutoff queued a slot (of {2 * S} tested), "
        f"{drains:.2f} full drains of 32 a slot, a last partial drain in "
        f"{partial:.3f} of the slots; the same window with no pair inside "
        f"the cutoff (tests, ballots and queue writes alone) "
        f"{tests_ms:.4f} ms device, so the drains take {f_ms - tests_ms:.4f} "
        f"of the kernel's {f_ms:.4f} ms")

    # how often sweep_bound re-measures: the rebuild flag of each of its
    # launches over untimed steps, summed on the device and read once;
    # and its launch without a rebuild
    state, rebuilds, bound_calls, stale, age = count_rebuilds(
        bound, state, k, REBUILD_STEPS)
    idle_ms = launch_ms(lambda: k.measure_bound(xT, L, ~flag, nb),
                        "sweep_bound_f32", reps=50)
    say(f"phase 7 K2 rebuilds: {rebuilds} of {bound_calls} sweep_bound "
        f"launches over {REBUILD_STEPS} untimed steps ran with the rebuild "
        f"flag set (one every {REBUILD_STEPS / max(rebuilds, 1):.2f} steps); "
        f"a launch without a rebuild {idle_ms:.5f} ms device, with one "
        f"{b_ms:.5f} ms ({smi})")
    # the bound on the path's own stale ring: its last rebuild before a
    # re-sort, the current positions gathered through the old order
    stale_nb = same_bound(k, plain, stale, L,
                          f"phase 7 the path's ring {age} steps after its "
                          f"sort")
    # the path's work: the kernel, its plain version and its floor there
    s_kernel = lambda: k.measure_bound(stale, L, flag, zero)  # noqa: E731
    s_plain = lambda: plain.measure_bound(stale, L, flag, zero)  # noqa: E731
    t = {}
    for label, fn, reps in (("plain", s_plain, 3), ("kernel", s_kernel, 20),
                            ("kernel2", s_kernel, 20), ("plain2", s_plain, 3)):
        t[label] = (launch_ms(fn, "sweep_bound_f32", reps=reps)
                    if label.startswith("kernel") else cuda_ms(fn, reps=reps))
    stale_ms = min(t["kernel"], t["kernel2"])
    stale_plain_ms = min(t["plain"], t["plain2"])
    stale_floor = bound_floor_tests(stale, L, k, stale_nb)
    stale_bound = bound_ms(b_bytes, stale_floor * OPS_DIST)
    stale_window = x_window_pairs(stale, L, k)
    stale_by_window = bound_ms(b_bytes, stale_window * OPS_DIST)
    assert stale_ms >= stale_bound[0], (stale_ms, stale_bound)
    say(f"phase 7 K2 sweep_bound on a rebuild, the path's stale ring ({age} "
        f"steps after its sort; bound {stale_nb} blocks against {int(nb)} "
        f"on the fresh ring): kernel {stale_ms:.5f} ms device, fresh ring "
        f"{b_ms:.5f} ms, one thread a slot "
        f"{K2_SLOT_A_THREAD_MS['sweep_bound']} ms; plain "
        f"{stale_plain_ms:.4f} ms; bound {stale_bound[0]:.6f} ms by "
        f"{stale_bound[1]} ({stale_floor} tile tests its scan cannot skip; "
        f"the {stale_window:.0f} pairs within w in x {stale_by_window[0]:.5f} "
        f"ms) ({smi})")
    for key in k.launches:
        k.launches[key] = launches[key]

    state, wall_ms, busy_ms, parts, top = profile_steps(bound, state, 50)
    step_ms = 1e3 / median
    say(f"phase 7 profile: K2 (bound + forces) device "
        f"{parts['K2 sweep'][0]:.4f} ms/step, the device busy {busy_ms:.4f} "
        f"ms/step ({smi})")
    say(f"phase 7 profile, 50 steps: {wall_ms:.3f} ms/step wall under the "
        f"profiler ({step_ms:.3f} without it), device busy {busy_ms:.3f} "
        f"ms/step: busy share {busy_ms / step_ms:.3f} of the unprofiled step "
        f"({busy_ms / wall_ms:.3f} of the profiled one)")
    say("phase 7 profile, device ms/step (host ms/step in the range) by "
        "part: " + "; ".join(f"{label} {dev_ms:.4f} ({host_ms:.3f})"
                             for label, (dev_ms, host_ms) in parts.items()))
    say("phase 7 profile, busiest device activities (ms/step): " + "; ".join(
        f"{name} {ms:.4f}" for name, ms in top))
    return [
        dict(name="sweep_forces", route="cuda", source=SWEEP_SOURCE,
             replaces=SWEEP_REPLACES, launches=launches["sweep_forces"],
             max_abs_err=k6["f"], ms=f_ms, plain_ms=f_plain_ms,
             bound_ms=f_bound[0], bound_by=f_bound[1], library_ms=None),
        # on the path's stale ring, the ring most of its rebuilds see
        dict(name="sweep_bound", route="cuda", source=SWEEP_SOURCE,
             replaces=SWEEP_REPLACES, launches=launches["sweep_bound"],
             max_abs_err=float(k6["nb"]), ms=stale_ms,
             plain_ms=stale_plain_ms, bound_ms=stale_bound[0],
             bound_by=stale_bound[1], library_ms=None),
    ], dict(steps_per_s_max=best, steps_per_s_median=median,
            ns_per_day=ns_day, step_ms_profiled=wall_ms,
            k2_rebuilds=rebuilds, k2_bound_launches=bound_calls,
            k2_rebuild_steps=REBUILD_STEPS, k2_bound_idle_ms=idle_ms,
            k2_bound_fresh_ms=b_ms, k2_bound_fresh_bound_ms=b_bound[0],
            k2_bound_stale_age=age,
            k2_bound_stale_x_window_ms=stale_by_window[0],
            k2_bound_fresh_x_window_ms=b_window[0],
            k2_bound_whole_ring_ms=b_whole[0],
            device_busy_ms=busy_ms, pme_ms=pme_ms, k2_queued_a_slot=queued,
            k2_drains_a_slot=drains, k2_tests_alone_ms=tests_ms,
            device_ms_by_part={k_: v[0] for k_, v in parts.items()})


# ---------------------------------------------------------------------------
# the alchemical path: K2's alchemical variant, Path A (equilibrium lambda
# window) and Path B (NCMC switching)
# ---------------------------------------------------------------------------


def alchemical_term(system):
    from openmmtools_tpu_torch.alchemy import AlchemicalNonbondedTerm

    (term,) = [t for t in system.terms if type(t) is AlchemicalNonbondedTerm]
    return term


def device_params(values, dev):
    return {name: torch.tensor(float(v), device=dev)
            for name, v in values.items()}


def alchemical_inputs(term, x, box, k, params):
    """The kernel's inputs for ``term`` at ``x`` in a fresh sort, with the
    class scalars of ``params`` and, for the 'exact' treatment, the scaled
    charges: (xT, par, excl, L, lam)."""
    from openmmtools_tpu_torch.ops import sweep_nb as tsw

    xT, par, excl, L, max_sep = tsw.sorted_inputs(term, x, box, k)
    assert int(max_sep) <= k.mask_shells
    lam, _, charge_scale = term.sweep_lambdas(params, xT)
    if charge_scale is not None:
        par = tsw.scale_charges_by_code(par, charge_scale)
    return xT, par, excl, L, lam.contiguous()


def alchemical_bound(xT, L, k, S):
    """The least time (ms, by) of one alchemical sweep at S shells: each
    pair of the window once, its inputs read and F, U written once."""
    tested, inside = sweep_pairs(xT, L, k, S)
    n_bytes = 4 * (3 * k.n_pad + 4 * k.n_pad + k.mask_rows * k.n_pad + 3 + 1
                   + k.n_lam + 3 * k.n_pad + 1)
    return bound_ms(n_bytes, tested * OPS_DIST + inside * OPS_PAIR_ALCH), \
        tested, inside


def phase_alchemical_kernels(dev, smi):
    from openmmtools_tpu_torch.alchemy import (
        AbsoluteAlchemicalFactory,
        AlchemicalRegion,
    )
    from openmmtools_tpu_torch.models import AlchemicalWaterBox, PMEWaterBox
    from openmmtools_tpu_torch.ops import sweep_nb as tsw

    # the direct-space cases on the model itself, the other treatments and
    # the two regions by the factory on the plain box it starts from
    w = AlchemicalWaterBox(box_edge=WATER_EDGE, device=dev)
    ref = w.system
    n = ref.n_particles
    box = ref.default_box
    base = PMEWaterBox(box_edge=WATER_EDGE, device=dev)
    assert torch.equal(base.positions, w.positions)
    one = AlchemicalRegion(alchemical_atoms=[0, 1, 2])
    two = [AlchemicalRegion(alchemical_atoms=[0, 1, 2], name="a",
                            annihilate_sterics=True),
           AlchemicalRegion(alchemical_atoms=[3, 4, 5], name="b",
                            annihilate_electrostatics=False)]
    exact = AbsoluteAlchemicalFactory(alchemical_pme_treatment="exact")
    coulomb = AbsoluteAlchemicalFactory(alchemical_pme_treatment="coulomb")
    plain_factory = AbsoluteAlchemicalFactory()

    def lams(v):
        return {"lambda_sterics": v, "lambda_electrostatics": v}

    pair = {"lambda_sterics_a": 0.55, "lambda_electrostatics_a": 0.55,
            "lambda_sterics_b": 0.3, "lambda_electrostatics_b": 0.3}
    cases = [
        ("direct-space, lambda 1", ref, lams(1.0)),
        ("direct-space, lambda 0.5", ref, lams(0.5)),
        ("direct-space, lambda 0", ref, lams(0.0)),
        ("exact, lambda 0.55",
         exact.create_alchemical_system(base.system, one), lams(0.55)),
        ("coulomb, lambda 0.55",
         coulomb.create_alchemical_system(base.system, one), lams(0.55)),
        ("two regions, interacting", plain_factory.create_alchemical_system(
            base.system, two, {("a", "b")}), pair),
        ("two regions, not interacting",
         plain_factory.create_alchemical_system(base.system, two), pair),
    ]
    mask_shells = min(2048, max(32, (-(-n // 128) * 128 // 2 // 32) * 32))
    flag = torch.tensor(True, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    worst = dict(f=0.0, f_rel=0.0, u_rel=0.0)
    for label, system, values in cases:
        term = alchemical_term(system)
        k = tsw.SweepNonbonded(
            n, term.method, term.cutoff, switch_width=term.switch_width,
            ewald_alpha=term.ewald_alpha, mask_shells=mask_shells,
            n_regions=term.n_regions,
            coulomb_pme_treatment=term.coulomb_pme_treatment)
        plain = tsw.PlainSweepNonbonded.like(k)
        xT, par, excl, L, lam = alchemical_inputs(
            term, w.positions, box, k, device_params(values, dev))
        nb = k.measure_bound(xT, L, flag, zero)
        nb2 = k.measure_bound(xT, L, flag, zero)
        nb_ref = plain.measure_bound(xT, L, flag, zero)
        F, U = k.sweep(xT, par, excl, L, nb, lam)
        F2, U2 = k.sweep(xT, par, excl, L, nb, lam)
        F_ref, U_ref = plain.sweep(xT, par, excl, L, nb_ref, lam)
        torch.cuda.synchronize()
        f_err = float((F - F_ref).abs().max())
        f_rel = max_rel(F, F_ref)
        u_rel = abs(float(U - U_ref)) / abs(float(U_ref))
        same = torch.equal(F, F2) and torch.equal(U, U2)
        assert k.launches == {"sweep_bound": 2, "sweep_forces_alch": 2}
        k_ms = launch_ms(lambda: k.sweep(xT, par, excl, L, nb, lam),
                         "sweep_forces_alch_f32", reps=20)
        p_ms = cuda_ms(lambda: plain.sweep(xT, par, excl, L, nb, lam),
                       reps=2)
        S = min(int(nb) * k.bs, k.n_pad // 2)
        (b_ms, b_by), tested, inside = alchemical_bound(xT, L, k, S)
        say(f"phase 8 alchemical sweep, {label} ({term.n_regions} "
            f"region(s), {k.n_lam} class scalars): bound {int(nb)} (a "
            f"second launch {int(nb2)}) vs plain {int(nb_ref)}, max|dF| "
            f"{f_err:.3e} (rel {f_rel:.2e}), U "
            f"{float(U):.4f} vs plain {float(U_ref):.4f} (rel {u_rel:.2e}); "
            f"a second launch gives the same bits: {same}; kernel "
            f"{k_ms:.4f} ms device, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"by {b_by} ({tested:.0f} pair tests, {inside:.0f} inside) "
            f"({smi})")
        assert int(nb) == int(nb2) == int(nb_ref), label
        assert f_rel <= REL_TOL and u_rel <= REL_TOL, (label, f_rel, u_rel)
        assert same, label
        worst = dict(f=max(worst["f"], f_err), f_rel=max(worst["f_rel"], f_rel),
                     u_rel=max(worst["u_rel"], u_rel))
    return worst


def compound_state(system):
    from openmmtools_tpu_torch.alchemy import AlchemicalState
    from openmmtools_tpu_torch.states import (
        CompoundThermodynamicState,
        ThermodynamicState,
    )

    return CompoundThermodynamicState(
        base_state=ThermodynamicState(system=system, temperature=WATER_T),
        composable_states=(AlchemicalState(**ALCH_LAMBDAS),))


def phase_alchemical_path(dev, smi, k8):
    from openmmtools_tpu_torch.integrators import BAOABIntegrator
    from openmmtools_tpu_torch.models import AlchemicalWaterBox

    t0 = time.perf_counter()
    w = AlchemicalWaterBox(box_edge=WATER_EDGE, device=dev)
    system = w.system
    compound = compound_state(system)
    bound = BAOABIntegrator(temperature=WATER_T, collision_rate=1.0,
                            timestep=0.002).bind(system)
    t_setup = time.perf_counter() - t0
    n = system.n_particles
    term = alchemical_term(system)
    assert term.force_group == 1 and not term.exact_electrostatics
    assert bound.sweep_mode and bound._sweep_alch is term, \
        "sweep mode did not take the alchemical term"
    assert bound._fused is None, "the fused LJ kernel took the water box"
    k = bound._sweep_kernel
    assert k.alchemical and k.n_regions == 1 and k.n_lam == 6
    assert set(k.launches) == {"sweep_bound", "sweep_forces_alch"}
    dof = 3 * n - system.constraints.n_constraints
    assert dof == 2 * n   # three constraints a water
    say(f"phase 9 setup: {n} atoms, alchemical atoms {term.region_id.ge(0).sum().item()}, "
        f"global parameters {dict(compound.global_params)}, n_pad {k.n_pad}; "
        f"built and bound in {t_setup:.2f} s")

    for key in k.launches:
        k.launches[key] = 0
    t1 = time.perf_counter()
    state = bound.initial_state(w.sampler_state(),
                                torch.Generator(device=dev).manual_seed(7),
                                thermodynamic_state=compound)
    torch.cuda.synchronize()
    say(f"phase 9 initial_state in {time.perf_counter() - t1:.2f} s")
    # the lattice start is still relaxing after the short warm-up: the
    # temperature is read after the timed chunks
    state, rates, steps = run_timed(bound, state, ALCH_WARMUP, system, dof,
                                    "phase 9", temperature_last=True)
    launches = dict(k.launches)
    say(f"phase 9 main path: {steps} steps; launches {launches}")
    for kernel, count in launches.items():
        assert count > 0, f"{kernel} never launched on the main path"
    # one evaluation a step, and one for initial_state
    assert launches["sweep_forces_alch"] == launches["sweep_bound"] == steps + 1
    best, median = max(rates), statistics.median(rates)
    ns_day = median * 0.002 * 86400 / 1e3
    say(f"phase 9 throughput: {best:.1f} steps/s max, {median:.1f} median "
        f"({len(rates)} timed chunks of {WATER_CHUNK}), {ns_day:.2f} ns/day "
        f"at 2 fs, on {smi}")
    plain = check_final_state(bound, state, "phase 9")
    same_bound(k, plain, *path_ring(bound, state),
               "phase 9 the path's own ring at the final state")

    # K2-alchemical at the final state, in turns with the plain version
    xT, par, excl, L, lam = alchemical_inputs(
        term, state.positions, system.default_box, k, state.global_params)
    flag = torch.tensor(True, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    same_bound(k, plain, xT, L, "phase 9 the final state, fresh ring")
    nb = k.measure_bound(xT, L, flag, zero)
    before = dict(k.launches)
    t = {}
    for label, fn, reps in (
            ("plain", lambda: plain.sweep(xT, par, excl, L, nb, lam), 3),
            ("kernel", lambda: k.sweep(xT, par, excl, L, nb, lam), 50),
            ("kernel2", lambda: k.sweep(xT, par, excl, L, nb, lam), 50),
            ("plain2", lambda: plain.sweep(xT, par, excl, L, nb, lam), 3)):
        t[label] = (launch_ms(fn, "sweep_forces_alch_f32", reps=reps)
                    if label.startswith("kernel") else cuda_ms(fn, reps=reps))
    for key in k.launches:   # the comparisons' launches are not the path's
        k.launches[key] = before[key]
    f_ms = min(t["kernel"], t["kernel2"])
    f_plain_ms = min(t["plain"], t["plain2"])
    S = min(int(nb) * k.bs, k.n_pad // 2)
    (b_ms, b_by), tested, inside = alchemical_bound(xT, L, k, S)
    say(f"phase 9 K2-alchemical at the final state (bound {int(nb)} blocks, "
        f"S = {S} shells): kernel {f_ms:.4f} ms device (one thread a slot: "
        f"{K2_SLOT_A_THREAD_MS['sweep_forces_alch']} ms), plain {f_plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms by {b_by} ({tested:.0f} pair tests, "
        f"{inside:.0f} pairs inside the cutoff) ({smi})")

    state, wall_ms, busy_ms, parts, top = profile_steps(bound, state, 50,
                                                        phase="phase 9")
    step_ms = 1e3 / median
    say(f"phase 9 profile: K2 (bound + forces) device "
        f"{parts['K2 sweep'][0]:.4f} ms/step, the device busy {busy_ms:.4f} "
        f"ms/step ({smi})")
    say(f"phase 9 profile, 50 steps: {wall_ms:.3f} ms/step wall under the "
        f"profiler ({step_ms:.3f} without it), device busy {busy_ms:.3f} "
        f"ms/step: busy share {busy_ms / step_ms:.3f} of the unprofiled step "
        f"({busy_ms / wall_ms:.3f} of the profiled one)")
    say("phase 9 profile, device ms/step (host ms/step in the range) by "
        "part: " + "; ".join(f"{label} {dev_ms:.4f} ({host_ms:.3f})"
                             for label, (dev_ms, host_ms) in parts.items()))
    say("phase 9 profile, busiest device activities (ms/step): " + "; ".join(
        f"{name} {ms:.4f}" for name, ms in top))

    # the sweep path against the dense alchemical term on a small box
    small = AlchemicalWaterBox(box_edge=SMALL_EDGE, device=dev)
    sc = compound_state(small.system)
    b_s = BAOABIntegrator(temperature=WATER_T).bind(small.system)
    b_d = BAOABIntegrator(temperature=WATER_T, sweep=None).bind(small.system)
    assert b_s.sweep_mode and b_s._sweep_alch is not None
    assert not b_d.sweep_mode
    gen = torch.Generator(device=dev)
    s_s = b_s.initial_state(small.sampler_state(), gen.manual_seed(1),
                            thermodynamic_state=sc)
    s_d = b_d.initial_state(small.sampler_state(), gen.manual_seed(1),
                            thermodynamic_state=sc)
    u_s, u_d = float(s_s.potentials[0]), float(s_d.potentials[0])
    u_rel = abs(u_s - u_d) / abs(u_d)
    f_rel = max_rel(s_s.forces[0], s_d.forces[0])
    say(f"phase 9 sweep against dense, {small.system.n_particles} atoms "
        f"({SMALL_EDGE} nm box): U {u_s:.4f} vs dense {u_d:.4f} (rel "
        f"{u_rel:.2e}), forces rel {f_rel:.2e}")
    # the JAX package's tolerances for its own alchemical sweep against the
    # dense term (tests/test_sweep_nb.py:214-249)
    assert u_rel <= 2e-3 and f_rel <= 2e-4
    kernel = dict(name="sweep_forces_alch", route="cuda", source=SWEEP_SOURCE,
                  replaces=SWEEP_REPLACES,
                  launches=launches["sweep_forces_alch"],
                  max_abs_err=k8["f"], ms=f_ms, plain_ms=f_plain_ms,
                  bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return kernel, state, system, dict(
        steps_per_s_max=best, steps_per_s_median=median, ns_per_day=ns_day,
        setup_s=t_setup, step_ms_profiled=wall_ms, device_busy_ms=busy_ms,
        device_ms_by_part={k_: v[0] for k_, v in parts.items()})


def phase_ncmc(dev, smi, state_a, system):
    from openmmtools_tpu_torch.integrators import (
        AlchemicalNonequilibriumLangevinIntegrator,
        BAOABIntegrator,
        ExternalPerturbationLangevinIntegrator,
    )
    from openmmtools_tpu_torch.ops import sweep_nb as tsw
    from openmmtools_tpu_torch.states import SamplerState

    integ = AlchemicalNonequilibriumLangevinIntegrator(
        alchemical_functions={"lambda_electrostatics": "1 - lambda"},
        n_steps_neq=NCMC_STEPS, temperature=WATER_T, collision_rate=1.0,
        timestep=0.002)
    assert integ.splitting == "O { V R H R V } O"
    bound = integ.bind(system)
    assert bound.sweep_mode and bound._sweep_alch is not None
    assert bound._fused is None
    k = bound._sweep_kernel
    # electrostatics switched off at full sterics, from Path A's last
    # configuration
    start = {**integ.initial_params(), "lambda_sterics": 1.0}
    for key in k.launches:
        k.launches[key] = 0
    state = bound.initial_state(bound.sampler_state_from(state_a),
                                torch.Generator(device=dev).manual_seed(11),
                                global_params=start)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = bound.run(state, NCMC_STEPS)
    work = float(state.protocol_work)
    rate = NCMC_STEPS / (time.perf_counter() - t0)
    launches = dict(k.launches)
    final = {name: float(v) for name, v in state.global_params.items()}
    accepted = int(state.n_accepted)
    say(f"phase 10 NCMC: one {NCMC_STEPS}-step protocol "
        f"(lambda_electrostatics = 1 - lambda, '{integ.splitting}'): "
        f"protocol work {work:.4f} kJ/mol, {accepted} of "
        f"{int(state.n_proposed)} blocks accepted, final lambda "
        f"{float(state.lambda_):.6f} after {state.lambda_step} H steps, "
        f"parameters {final}; {rate:.2f} steps/s ("
        f"{rate * 0.002 * 86400 / 1e3:.2f} ns/day at 2 fs); launches "
        f"{launches} ({smi})")
    for kernel, count in launches.items():
        assert count > 0, f"{kernel} never launched on the NCMC path"
    assert math.isfinite(work) and torch.isfinite(state.positions).all()
    assert float(state.lambda_) == 1.0 and final["lambda_electrostatics"] == 0.0
    assert int(state.n_proposed) == NCMC_STEPS
    same_bound(k, tsw.PlainSweepNonbonded.like(k), *path_ring(bound, state),
               "phase 10 the protocol's own ring at its end")

    # external perturbation: lambda_electrostatics 1 -> 0 between steps
    ext = ExternalPerturbationLangevinIntegrator(
        temperature=WATER_T, collision_rate=1.0, timestep=0.002)
    b_e = ext.bind(system)
    assert b_e.sweep_mode and b_e._sweep_alch is not None
    s_e = b_e.initial_state(bound.sampler_state_from(state_a),
                            torch.Generator(device=dev).manual_seed(13),
                            global_params={"lambda_electrostatics": 1.0,
                                           "lambda_sterics": 1.0})
    s_e = b_e.run(s_e, 1)
    # the independent sum: the plain sweep plus the remainder in float64
    system64 = system.to(dtype=torch.float64)
    ref = BAOABIntegrator(temperature=WATER_T, sweep="force").bind(system64)
    ref._sweep_kernel = tsw.PlainSweepNonbonded.like(ref._sweep_kernel)
    box = system.default_box
    box64 = box.double()

    def same_path(state, params):
        sw = b_e._sweep_dict(state)
        return float(b_e._group_energy_forces(None, state.positions, box,
                                              params, sw)[0])

    def plain64(x, params, s64=None):
        p64 = {name: v.double() for name, v in params.items()}
        if s64 is None:
            s64 = ref.initial_state(
                SamplerState(positions=x.double(),
                             velocities=torch.zeros_like(x, dtype=torch.float64),
                             box_vectors=box64), torch.Generator(device=dev),
                global_params=p64)
            return float(s64.potentials[0]), s64
        return float(ref._sweep_eval(x.double(), box64, p64,
                                     ref._sweep_dict(s64))[0]), s64

    same = indep = 0.0
    for step in range(PERTURB_STEPS):
        lam = 1.0 - float(step + 1) / PERTURB_STEPS
        old = dict(s_e.global_params)
        new = {**old, "lambda_electrostatics": torch.tensor(lam, device=dev)}
        same += same_path(s_e, new) - same_path(s_e, old)
        u_old, s64 = plain64(s_e.positions, old)
        u_new, _ = plain64(s_e.positions, new, s64)
        indep += u_new - u_old
        s_e = b_e.perturb(s_e, new)
        s_e = b_e.run(s_e, 1)
        w = float(s_e.protocol_work)
        # the tolerances of tests/test_nonequilibrium.py:382-420: tight
        # against the same evaluation path, and against the independent
        # evaluation at the cross-program floor
        assert math.isclose(w, same, rel_tol=1e-5, abs_tol=5e-4), (step, w, same)
        assert math.isclose(w, indep, rel_tol=1e-3, abs_tol=2e-2), (
            step, w, indep)
    say(f"phase 10 external perturbation: {PERTURB_STEPS} steps, "
        f"lambda_electrostatics 1 -> 0: protocol work {w:.5f} kJ/mol, the "
        f"same differences summed outside the integrator {same:.5f}, the "
        f"plain sweep + remainder in float64 {indep:.5f} (diff "
        f"{w - indep:.2e})")
    return dict(protocol_work=work, accepted=accepted,
                steps_per_s=rate, launches=launches,
                perturb_work=w, perturb_independent=indep)


# ---------------------------------------------------------------------------
# the LJ cell-list slice: K3 (the dense BAOAB chunk) and K4 (the cell grid)
# ---------------------------------------------------------------------------


def dense_program(fluid, collision_rate=1.0):
    from openmmtools_tpu_torch.ops.fused_langevin import FusedDenseBAOAB

    t = fluid.system.terms[0]
    return FusedDenseBAOAB(
        fluid.n_particles, t.cutoff, t.switch_width, float(t.sigma[0]),
        float(t.epsilon[0]), float(fluid.system.masses[0]), 0.002,
        collision_rate, device=fluid.positions.device)


def cell_program(fluid, collision_rate=1.0, **kw):
    from openmmtools_tpu_torch.ops import fused_md as tmd

    t = fluid.system.terms[0]
    spec = tmd.make_grid_spec(
        fluid.n_particles, fluid.box_edge, t.cutoff, t.switch_width,
        float(t.sigma[0]), float(t.epsilon[0]), float(fluid.system.masses[0]),
        0.002, collision_rate)
    return tmd.FusedLJBAOAB(spec, fluid.n_particles, temperature=TEMPERATURE,
                            device=fluid.positions.device, **kw)


def thermal(n, dev, seed):
    from openmmtools_tpu_torch.constants import kB

    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((n, 3), device=dev, generator=gen) * (
        (kB * TEMPERATURE / 39.9) ** 0.5)


def mean_temperature(step, masses, x, v, label):
    """50 kinetic-temperature samples 100 steps apart by ``step(x, v, 100)``,
    after 1,000 steps; the mean within 5 % of the target."""
    from openmmtools_tpu_torch.system import instantaneous_temperature

    x, v = step(x, v, 1000)
    temps = []
    for _ in range(50):
        x, v = step(x, v, 100)
        temps.append(float(instantaneous_temperature(masses, v)))
    mean_t = statistics.fmean(temps)
    say(f"{label} thermostat: mean kinetic temperature {mean_t:.3f} K over "
        f"50 samples 100 steps apart (target {TEMPERATURE} K, sd "
        f"{statistics.stdev(temps):.3f} K)")
    assert abs(mean_t - TEMPERATURE) < 0.05 * TEMPERATURE


def timed_chunks(run, x, v, chunk_line=None):
    """bench.py's drive: a 50,000-step warm-up, then 50,000-step chunks, each
    ending in a host fetch of the positions, for up to 8 s (at least two).
    Returns (x, v, the chunks' steps/s)."""
    x, v = run(x, v, CHUNK)
    torch.cuda.synchronize()
    rates = []
    t0 = time.perf_counter()
    while len(rates) < 2 or (time.perf_counter() - t0 < 8.0
                             and len(rates) < 12):
        tc = time.perf_counter()
        x, v = run(x, v, CHUNK)
        positions = x.cpu().numpy()
        rates.append(CHUNK / (time.perf_counter() - tc))
        assert positions.shape == (N, 3)
        assert bool((positions == positions).all()), "non-finite positions"
        if chunk_line is not None:
            say(chunk_line(len(rates), rates[-1]))
    return x, v, rates


def phase_dense(dev, smi, k):
    from openmmtools_tpu_torch.constants import kB
    from openmmtools_tpu_torch.models import LennardJonesFluid
    from openmmtools_tpu_torch.ops.fused_langevin import (
        fused_langevin_reference,
    )
    from openmmtools_tpu_torch.system import make_energy_force_fn

    fluid = LennardJonesFluid(nparticles=N, device=dev)
    box = fluid.system.default_box
    edge = float(fluid.box_edge)
    kT = kB * TEMPERATURE
    v0 = k["v"]

    # the kernel against its plain version: n_steps = 0, then 40-step chunks
    kd = dense_program(fluid)
    out = kd.chunk(fluid.positions, v0, box, kT, 4242, 0)
    ref = fused_langevin_reference(kd.program, fluid.positions, v0, box, kT,
                                   4242, 0)
    torch.cuda.synchronize()
    f_err = float((out[2] - ref[2]).abs().max())
    f_rel = max_rel(out[2], ref[2])
    u_rel = abs(float(out[3] - ref[3])) / abs(float(ref[3]))
    say(f"phase 11 dense_baoab N={N}, 0 steps: max|dF| {f_err:.3e} (rel "
        f"{f_rel:.2e}), U {float(out[3]):.6f} vs plain {float(ref[3]):.6f} "
        f"(rel {u_rel:.2e})")
    assert f_rel <= REL_TOL and u_rel <= REL_TOL, (f_rel, u_rel)
    for gamma in (0.0, 1.0):
        p = dense_program(fluid, gamma)
        out = p.chunk(fluid.positions, v0, box, kT, 4242, 40)
        ref = fused_langevin_reference(p.program, fluid.positions, v0, box,
                                       kT, 4242, 40)
        dx = wrapped_dx(out[0], ref[0], edge)
        dv = float((out[1] - ref[1]).abs().max())
        v_scale = float(ref[1].abs().max())
        du = abs(float(out[3] - ref[3])) / abs(float(ref[3]))
        df = max_rel(out[2], ref[2])
        say(f"phase 11 dense_baoab chunk gamma={gamma}, 40 steps, one "
            f"launch: dx {dx:.2e} dv/v {dv / v_scale:.2e} dU/U {du:.2e} "
            f"dF/F {df:.2e}")
        assert p.launches == {"dense_baoab": 1}
        assert dx < 5e-4 and dv < 5e-3 * v_scale and du <= REL_TOL \
            and df <= REL_TOL, (gamma, dx, dv, du, df)

    # the main path: run as bench.py drives a run
    gen = torch.Generator().manual_seed(0)
    state = {}

    def run(x, v, n_steps):
        x, v, state["F"], state["U"] = kd.run(x, v, box, kT, gen, n_steps)
        return x, v

    kd.launches["dense_baoab"] = 0
    x, v, rates = timed_chunks(run, fluid.positions, v0)
    launches = kd.launches["dense_baoab"]
    say(f"phase 11 main path: {CHUNK * (1 + len(rates))} steps in "
        f"{1 + len(rates)} chunks; launches {{'dense_baoab': {launches}}}")
    assert launches == 1 + len(rates), launches
    assert torch.isfinite(x).all() and torch.isfinite(v).all()
    u_ref, f_ref = make_energy_force_fn(fluid.system)(x)
    u_rel = abs(float(state["U"] - u_ref)) / abs(float(u_ref))
    f_rel = max_rel(state["F"], f_ref)
    say(f"phase 11 final state: U {float(state['U']):.4f} vs dense "
        f"{float(u_ref):.4f} (rel {u_rel:.2e}), forces rel {f_rel:.2e}")
    assert u_rel <= REL_TOL and f_rel <= REL_TOL
    best, median = max(rates), statistics.median(rates)
    say(f"phase 11 throughput: {best:.1f} steps/s max, {median:.1f} median "
        f"({len(rates)} timed chunks of {CHUNK}) on {smi}")
    mean_temperature(run, fluid.system.masses, x, v, "phase 11")

    # kernel and plain time per step at the main path's final state
    L = torch.diagonal(box).contiguous()
    t = {}
    for label, fn, steps, reps in (
            ("plain", lambda: fused_langevin_reference(
                kd.program, x, v, box, kT, 5, 20), 20, 2),
            ("kernel", lambda: kd.chunk(x, v, box, kT, 5, TIMED_STEPS),
             TIMED_STEPS, 3),
            ("kernel2", lambda: kd.chunk(x, v, box, kT, 5, TIMED_STEPS),
             TIMED_STEPS, 3),
            ("plain2", lambda: fused_langevin_reference(
                kd.program, x, v, box, kT, 5, 20), 20, 2)):
        t[label] = cuda_ms(fn, reps=reps) / steps
    ms = min(t["kernel"], t["kernel2"])
    plain_ms = min(t["plain"], t["plain2"])
    # the bound of a step of the chunk at this state's pairs
    n_tests, n_in = lj_pair_counts(x.t().contiguous(), L, kd.program.rc)
    b_ms, b_by = chunk_bound_ms(kd.program, TIMED_STEPS, n_tests, n_in)
    say(f"phase 11 dense_baoab per step ({TIMED_STEPS}-step chunk, one "
        f"launch): kernel {ms:.5f} ms, plain {plain_ms:.5f} ms (20-step "
        f"chunk), bound {b_ms:.6f} ms by {b_by} ({n_tests} pair tests, "
        f"{n_in} pairs inside the cutoff a step) ({smi})")
    # where K3's step goes: its kernel at n_steps = 0 (the wrap and one
    # all-pairs evaluation with its energy, two grid barriers) beside K1's
    # forces launch (the same sweep, its energy summed in the launch) on the
    # same positions, device time of each
    xT = (x - L * torch.floor(x / L)).t().contiguous()
    kT_t = torch.tensor([kT], device=dev)
    one_ms = launch_ms(lambda: kd.chunk(x, v, box, kT_t, 5, 0),
                       "lj_chunk_f32", reps=20)
    k1_ms = launch_ms(lambda: kd.program.forces(xT, L), "lj_forces_f32",
                      reps=20)
    kd.launches["dense_baoab"] = launches
    say(f"phase 11 one all-pairs evaluation at the final state, device time: "
        f"the chunk kernel at 0 steps {one_ms:.5f} ms, K1's lj_forces_f32 "
        f"{k1_ms:.5f} ms ({smi})")
    return dict(name="dense_baoab_chunk", route="cuda", source=DENSE_SOURCE,
                replaces=DENSE_REPLACES, launches=launches, max_abs_err=f_err,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, per="step"), dict(
        steps_per_s_max=best, steps_per_s_median=median, step_ms=ms,
        one_evaluation_ms=one_ms, k1_forces_ms=k1_ms)


def cell_pair_counts(x_slots, valid, spec, rows):
    """The slot pairs a cell-grid evaluation needs, each once: unordered
    pairs of valid slots in the same or adjacent cells, and those inside the
    cutoff."""
    from openmmtools_tpu_torch.ops import fused_md as tmd

    interior, neighbours = tmd._grid_geometry(spec, x_slots.device)
    xi = x_slots[:, :rows, interior]
    vi = valid[:rows, interior] > 0
    tested = inside = 0
    for gn, shift in neighbours:
        xj = x_slots[:, :rows, gn] + shift[:, None, :]
        d = xi[:, :, None, :] - xj[:, None, :, :]
        r2 = (d * d).sum(0)
        pair = vi[:, None, :] & (valid[:rows, gn] > 0)[None, :, :] & (
            r2 > tmd.R2_MIN)
        tested += int(pair.sum())
        inside += int((pair & (r2 < spec.cutoff ** 2)).sum())
    return tested // 2, inside // 2


def cell_forces_check(kc, x, label, v=None):
    """K4's forces kernel on the bin of positions x (N, 3) (velocities v,
    default 0) by ``kc``: against its plain version and against the dense
    all-pairs sum. Returns (bin, F, max|dF|)."""
    from openmmtools_tpu_torch.ops import fused_md as tmd
    from openmmtools_tpu_torch.ops.fused_langevin import lj_forces_reference

    xs, vs, valid, sp, mo = kc.bin(x, torch.zeros_like(x) if v is None else v)
    spec = kc.spec
    F = kc.forces(xs, valid, rows=mo)
    F_ref = tmd.cell_forces_reference(xs, valid, kc.spec)
    n = x.shape[0]
    Fp, _ = tmd.unbin_particles(F, F, sp, n)
    xw, _ = tmd.unbin_particles(xs, xs, sp, n)
    L = torch.full((3,), spec.box_edge, device=x.device)
    F_dense, _ = lj_forces_reference(
        xw.t().contiguous(), L, cutoff=spec.cutoff,
        switch_width=spec.switch_width, sigma=spec.sigma,
        epsilon=spec.epsilon)
    torch.cuda.synchronize()
    f_err = float((F - F_ref).abs().max())
    rel_plain, rel_dense = max_rel(F, F_ref), max_rel(Fp, F_dense.t())
    say(f"{label}: max occupancy {mo} of capacity {spec.capacity}; max|dF| "
        f"{f_err:.3e} (rel {rel_plain:.2e}) against plain, rel "
        f"{rel_dense:.2e} against the dense sum")
    assert rel_plain <= REL_TOL and rel_dense <= REL_TOL
    return (xs, vs, valid, sp, mo), F, f_err


def phase_cell(dev, smi):
    from openmmtools_tpu_torch.constants import kB
    from openmmtools_tpu_torch.integrators import fire_minimize
    from openmmtools_tpu_torch.models import LennardJonesFluid
    from openmmtools_tpu_torch.ops import fused_md as tmd
    from openmmtools_tpu_torch.ops.fused_langevin import FusedSortedLangevin

    fluid = LennardJonesFluid(nparticles=N, device=dev)
    box = fluid.system.default_box
    edge = float(fluid.box_edge)
    kT = kB * TEMPERATURE
    kc = cell_program(fluid)
    spec = kc.spec
    say(f"phase 12 grid: n_side {spec.n_side}, capacity {spec.capacity}, "
        f"G {spec.g_cells}, cell edge {spec.cell_edge:.4f} nm (cutoff "
        f"{spec.cutoff} nm), rebuild interval {kc.rebuild_interval}")
    assert (spec.n_side, spec.capacity, spec.g_cells,
            kc.rebuild_interval) == (8, 16, 1000, 175)
    _, _, f_err = cell_forces_check(kc, fluid.positions,
                                    "phase 12 cell_forces, Sobol start")

    # a noisy 40-step run across one rebin against the plain run
    v0 = thermal(N, dev, 1)
    ka = cell_program(fluid, rebuild_interval=20)
    kp = cell_program(fluid, rebuild_interval=20)
    xa, va = ka.run(fluid.positions, v0, kT, torch.Generator().manual_seed(6),
                    40)
    xb, vb = tmd.fused_lj_reference(kp, fluid.positions, v0, kT,
                                    torch.Generator().manual_seed(6), 40)
    run_dx, dv = wrapped_dx(xa, xb, edge), float((va - vb).abs().max())
    v_scale = float(vb.abs().max())
    say(f"phase 12 run gamma=1, 40 steps across a rebin: launches "
        f"{ka.launches}; dx {run_dx:.2e} dv/v {dv / v_scale:.2e} against "
        f"plain")
    assert ka.launches == {"cell_forces": 2, "cell_chunk": 2}
    assert run_dx < 5e-4 and dv < 5e-3 * v_scale, (run_dx, dv)

    # gamma = 0 from a FIRE-minimized start: K4 against K3's kernel
    xmin, _ = fire_minimize(fluid.system, fluid.positions, box, max_steps=200)
    k0 = cell_program(fluid, 0.0, rebuild_interval=25)
    xa, va = k0.run(xmin, v0, kT, torch.Generator(), 100)
    xb, vb, _, _ = dense_program(fluid, 0.0).run(xmin, v0, box, kT,
                                                  torch.Generator(), 100)
    dx, dv = wrapped_dx(xa, xb, edge), float((va - vb).abs().max())
    v_scale = float(vb.abs().max())
    say(f"phase 12 gamma=0, 100 steps (rebin every 25) from a FIRE-minimized "
        f"start: dx {dx:.2e} dv/v {dv / v_scale:.2e} against K3's kernel")
    assert dx < 5e-4 and dv < 5e-3 * v_scale, (dx, dv)

    gen = torch.Generator().manual_seed(2)
    kt = cell_program(fluid)
    mean_temperature(lambda x, v, n: kt.run(x, v, kT, gen, n),
                     fluid.system.masses, xmin, v0, "phase 12")

    # the main path: run in 50,000-step chunks from the minimized start
    km = cell_program(fluid)
    for key in km.launches:
        km.launches[key] = 0
    bins = []
    # keep the main path's fullest bin: its positions and velocities
    fullest = {"occupancy": -1}
    bin_ = km.bin

    def bin_keeping_the_fullest(x, v):
        out = bin_(x, v)
        if out[4] > fullest["occupancy"]:
            fullest.update(occupancy=out[4], x=x, v=v)
        return out

    km.bin = bin_keeping_the_fullest

    def run(x, v, n_steps):
        x, v = km.run(x, v, kT, gen, n_steps)
        bins.append(-(-n_steps // km.rebuild_interval))
        return x, v

    def chunk_line(i, rate):
        return (f"phase 12 chunk {i}: {rate:.1f} steps/s, capacity "
                f"{km.spec.capacity}, max occupancy {km.max_occupancy}, "
                f"capacity bumps so far {km.capacity_bumps}")

    x, v, rates = timed_chunks(run, xmin, v0, chunk_line)
    del km.bin
    launches = dict(km.launches)
    say(f"phase 12 main path: {CHUNK * (1 + len(rates))} steps in "
        f"{1 + len(rates)} runs ({sum(bins)} bins); launches {launches}; "
        f"fullest bin: occupancy {fullest['occupancy']}")
    assert launches["cell_forces"] == launches["cell_chunk"] == sum(bins) > 0
    assert torch.isfinite(x).all() and torch.isfinite(v).all()
    best, median = max(rates), statistics.median(rates)
    say(f"phase 12 throughput: {best:.1f} steps/s max, {median:.1f} median "
        f"({len(rates)} timed chunks of {CHUNK}) on {smi}")

    # the main path's own program at its own shapes (capacity and rows as
    # the condensed fluid raised them): the final state, then the fullest
    # bin, forces and a noisy 40-step chunk against the plain versions
    cell_forces_check(km, x, "phase 12 cell_forces, final state")
    (xs, vs, valid, sp, mo), _, f_err_full = cell_forces_check(
        km, fullest["x"], "phase 12 cell_forces, the main path's fullest bin",
        v=fullest["v"])
    assert mo == fullest["occupancy"]
    kT_t = torch.tensor([kT], device=dev)
    xa, va = km.chunk(xs.clone(), vs.clone(), valid, kT_t, 8, 40, rows=mo)
    xb, vb = tmd.cell_chunk_reference(xs, vs, valid, kT_t, 8, 40, km.spec, mo)
    occupied = valid[None] > 0
    chunk_dx = float(((xa - xb) * occupied).abs().max())
    dv = float(((va - vb) * occupied).abs().max())
    v_scale = float(vb.abs().max())
    say(f"phase 12 cell_chunk, the fullest bin (occupancy {mo}, capacity "
        f"{km.spec.capacity}), 40 steps gamma=1: dx {chunk_dx:.2e} dv/v "
        f"{dv / v_scale:.2e} against plain")
    assert chunk_dx < 5e-4 and dv < 5e-3 * v_scale, (chunk_dx, dv)

    # no float atomics and a fixed summation order: the forces and a
    # 175-step chunk (an odd count: the final positions are copied back),
    # each launched twice on the same inputs, give the same bits
    steps = km.rebuild_interval
    same_f = torch.equal(km.forces(xs, valid, rows=mo),
                         km.forces(xs, valid, rows=mo))
    twice = [km.chunk(xs.clone(), vs.clone(), valid, kT_t, 8, steps, rows=mo)
             for _ in range(2)]
    same_c = all(torch.equal(a, b) for a, b in zip(*twice))
    say(f"phase 12 the same bits twice at the fullest bin: cell_forces "
        f"{same_f}, cell_chunk ({steps} steps, gamma=1) {same_c}")
    assert same_f and same_c

    # times at the fullest bin, in turns with the plain versions: the
    # kernels' device time (a wrapper call is host-bound: it makes the
    # occupancy and the forces buffer with small torch operations first),
    # the wrapper call and the plain versions by CUDA events
    forces = lambda: km.forces(xs, valid, rows=mo)  # noqa: E731
    chunk = lambda: km.chunk(xs.clone(), vs.clone(), valid, kT_t, 5,  # noqa: E731
                             steps, rows=mo)
    xf, vf = fullest["x"], fullest["v"]
    empty = torch.zeros_like(valid)
    t = {}
    for label, fn, reps, per in (
            ("plain_f", lambda: tmd.cell_forces_reference(xs, valid, km.spec,
                                                          mo), 5, 1),
            ("kernel_f", (forces, "cell_forces_f32"), 50, 1),
            ("kernel_f2", (forces, "cell_forces_f32"), 50, 1),
            ("plain_f2", lambda: tmd.cell_forces_reference(xs, valid,
                                                           km.spec, mo), 5, 1),
            ("wrapper_f", forces, 100, 1),
            ("plain_c", lambda: tmd.cell_chunk_reference(
                xs, vs, valid, kT_t, 5, 5, km.spec, mo), 2, 5),
            ("kernel_c", (chunk, "cell_chunk_f32"), 10, steps),
            ("kernel_c2", (chunk, "cell_chunk_f32"), 10, steps),
            ("plain_c2", lambda: tmd.cell_chunk_reference(
                xs, vs, valid, kT_t, 5, 5, km.spec, mo), 2, 5),
            ("rebin", lambda: tmd.unbin_particles(*km.bin(xf, vf)[:2], sp, N),
             20, 1),
            ("rebin2", lambda: tmd.unbin_particles(*km.bin(xf, vf)[:2], sp,
                                                   N), 20, 1),
            # the force kernel's launch on a bin with no particle: every
            # block reads one occupancy and returns
            ("empty_f", (lambda: km.forces(xs, empty, rows=mo),
                         "cell_forces_f32"), 50, 1),
            # a chunk on it: each step one occupancy read a cell and the
            # grid barrier
            ("empty_c", (lambda: km.chunk(xs.clone(), vs.clone(), empty,
                                          kT_t, 5, steps, rows=mo),
                         "cell_chunk_f32"), 10, steps),
            # one chunk of run as the main path drives it (bin with its host
            # read, forces, chunk, unbin), wall time by CUDA events
            ("run", lambda: km.run(xf, vf, kT_t, gen, steps), 20, 1),
            ("run2", lambda: km.run(xf, vf, kT_t, gen, steps), 20, 1)):
        t[label] = (launch_ms(*fn, reps=reps) if isinstance(fn, tuple)
                    else cuda_ms(fn, reps=reps)) / per
    f_ms, f_plain = (min(t["kernel_f"], t["kernel_f2"]),
                     min(t["plain_f"], t["plain_f2"]))
    c_ms, c_plain = (min(t["kernel_c"], t["kernel_c2"]),
                     min(t["plain_c"], t["plain_c2"]))
    rebin_ms = min(t["rebin"], t["rebin2"])
    run_ms = min(t["run"], t["run2"])
    for key in km.launches:   # the timings' launches are not the path's
        km.launches[key] = launches[key]
    M, G = km.spec.capacity, km.spec.g_cells
    tested, inside = cell_pair_counts(xs, valid, km.spec, mo)
    pair_ops = tested * OPS_DIST + inside * OPS_PAIR
    # bytes of the occupied slots only (the kernels touch no other): forces
    # read x and the occupancy and write F; a chunk reads x, v, F and the
    # occupancy and kT, and writes x and v. cell_chunk_kernel evaluates the
    # forces once a step (cell_forces_kernel the chunk's start)
    n_slots = int((valid > 0).sum())
    f_bound = bound_ms(4 * (3 * n_slots * 2 + G), pair_ops)
    c_bound = bound_ms(4 * (3 * n_slots * 3 + G + 1 + 3 * n_slots * 2),
                       steps * pair_ops)
    c_bound = (c_bound[0] / steps, c_bound[1])
    say(f"phase 12 at the fullest bin (max occupancy {mo}, capacity {M}): "
        f"cell_forces kernel {f_ms:.5f} ms (device; the wrapper call "
        f"{t['wrapper_f']:.5f} ms), plain {f_plain:.4f} ms, bound "
        f"{f_bound[0]:.6f} ms by {f_bound[1]} ({tested} slot pairs tested, "
        f"{inside} inside the cutoff); cell_chunk per step ({steps}-step "
        f"chunk, device) kernel {c_ms:.5f} ms, plain {c_plain:.4f} ms (5-step "
        f"chunk), bound {c_bound[0]:.6f} ms by {c_bound[1]}; torch rebin (bin "
        f"with its host read + unbin) {rebin_ms:.4f} ms a chunk ({smi})")
    # where a step goes: the chunk's step less its step on an empty bin
    # (the grid barrier) is the staging, the pairs and the update; the
    # forces launch less its launch on an empty bin is the staging and the
    # pairs
    barrier = t["empty_c"]
    work_f = f_ms - t["empty_f"]
    say(f"phase 12 split of a step at the fullest bin: cell_chunk "
        f"{c_ms:.5f} ms a step, of which {barrier:.5f} ms the grid barrier "
        f"with one occupancy read a cell (a chunk on an empty bin), so "
        f"{c_ms - barrier:.5f} ms staging, pairs and update; cell_forces "
        f"{f_ms:.5f} ms a launch, of which {t['empty_f']:.5f} ms the launch "
        f"on an empty bin, so {work_f:.5f} ms staging and pairs ({smi})")
    # the host queues a chunk's unbin and the next bin while the chunk's
    # kernels run, so the rebin timed alone overlaps them in run
    kernels_ms = f_ms + steps * c_ms
    rest_ms = run_ms - kernels_ms
    say(f"phase 12 split of one {steps}-step chunk of run at the fullest "
        f"bin: wall {run_ms:.4f} ms ({steps / run_ms * 1e3:.1f} steps/s); "
        f"the kernels' device time {kernels_ms:.4f} ms "
        f"({kernels_ms / run_ms:.3f}); the rest {rest_ms:.4f} ms "
        f"({rest_ms / run_ms:.3f}): the part of the rebin (timed alone back "
        f"to back {rebin_ms:.4f} ms) and of the wrappers' host work that the "
        f"kernels do not hide ({smi})")

    # the cell-list question at two sizes: K4's forces beside K1's on the
    # same positions (printed, not asserted); at N the main path's program
    # at its final state
    sizes = []
    for n, xn in ((N, x), (CELL_N_LARGE, None)):
        fl = fluid if xn is not None else LennardJonesFluid(
            nparticles=n, device=dev)
        xn = fl.positions if xn is None else xn
        kn = km if n == N else cell_program(fl)
        xs_n, _, valid_n, _, mo_n = kn.bin(xn, torch.zeros_like(xn))
        tn = fl.system.terms[0]
        k1 = FusedSortedLangevin(n, tn.cutoff, tn.switch_width,
                                 float(tn.sigma[0]), float(tn.epsilon[0]),
                                 39.9, 0.002, 1.0)
        L = torch.diagonal(fl.system.default_box).contiguous()
        xT = (xn - L * torch.floor(xn / L)).t().contiguous()
        k4_ms = launch_ms(lambda: kn.forces(xs_n, valid_n, rows=mo_n),
                          "cell_forces_f32")
        k1_ms = launch_ms(lambda: k1.forces(xT, L), "lj_forces_f32",
                          reps=20)
        sizes.append(dict(n=n, k4_forces_ms=k4_ms, k1_lj_forces_ms=k1_ms,
                          max_occupancy=mo_n, capacity=kn.spec.capacity))
        say(f"phase 12 cell list against all pairs, N={n}, device time: K4 "
            f"cell_forces_f32 {k4_ms:.5f} ms (max occupancy {mo_n}, "
            f"capacity {kn.spec.capacity}), K1 lj_forces_f32 {k1_ms:.5f} "
            f"ms, ratio {k1_ms / k4_ms:.2f} ({smi})")
    return [
        dict(name="cell_forces", route="cuda", source=CELL_SOURCE,
             replaces=CELL_REPLACES, launches=launches["cell_forces"],
             max_abs_err=max(f_err, f_err_full), ms=f_ms, plain_ms=f_plain,
             bound_ms=f_bound[0], bound_by=f_bound[1], library_ms=None),
        dict(name="cell_chunk", route="cuda", source=CELL_SOURCE,
             replaces=CELL_REPLACES, launches=launches["cell_chunk"],
             max_abs_err=max(run_dx, chunk_dx), ms=c_ms, plain_ms=c_plain,
             bound_ms=c_bound[0], bound_by=c_bound[1], library_ms=None,
             per="step"),
    ], dict(steps_per_s_max=best, steps_per_s_median=median,
            capacity=km.spec.capacity, capacity_bumps=km.capacity_bumps,
            fullest_occupancy=mo, rebin_ms=rebin_ms, chunk_wall_ms=run_ms,
            empty_forces_ms=t["empty_f"], empty_chunk_step_ms=barrier,
            cell_list_question=sizes)


# -- phase 13: the MCMC layer --------------------------------------------------

MCMC_ITERATIONS = 10
MCMC_KERNELS = ("lj_forces_f32", "lj_chunk_f32", "sweep_bound_f32",
                "sweep_forces_f32")
ANDERSEN_STEPS = 2_000
MC_SIGMA = 1e-4          # nm: all 2,048 particles move at once
WATER_GHMC_STEPS = 50


class recording:
    """Within the block, each C entry point of ``MCMC_KERNELS`` records a
    CUDA event pair around each of its launches (``launch_events``): the
    span of every launch by entry point, its device time plus any wait of
    the card for the launch's submission."""

    def __enter__(self):
        self.recs = {e: launch_events(e).__enter__() for e in MCMC_KERNELS}
        return self

    def __exit__(self, *exc):
        for rec in self.recs.values():
            rec.__exit__(*exc)

    def count(self):
        return {e: len(rec.pairs) for e, rec in self.recs.items()}

    def span_ms(self):
        torch.cuda.synchronize()
        return {e: sum(rec.ms()) for e, rec in self.recs.items()}


def timed_moves(moves, last):
    """Each move's ``apply`` timed by the wall clock (synchronized) and its
    integrator moves' final integrator states kept in ``last``; returns the
    list of wall ms by move name."""
    walls = {name: [] for name in moves}
    for name, move in moves.items():
        apply = move.apply

        def timed(ts, ss, _apply=apply, _name=name, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = _apply(ts, ss, **kw)
            torch.cuda.synchronize()
            walls[_name].append(1e3 * (time.perf_counter() - t))
            return out

        move.apply = timed
        if hasattr(move, "_on_integration_end"):
            hook = move._on_integration_end

            def keep(state, _hook=hook, _name=name):
                last[_name] = state
                _hook(state)

            move._on_integration_end = keep
    return walls


def phase_mcmc(dev, smi):
    """13a: an NPT MCMC run on LJ-2048 through the moves that reach K1 (the
    Langevin move's fused chunk) and K2 (sweep mode under the GHMC and HMC
    moves), with a displacement and a barostat move."""
    from openmmtools_tpu_torch.constants import BAR_TO_KJ_PER_MOL_NM3, kB
    from openmmtools_tpu_torch.mcmc import (
        GHMCMove,
        HMCMove,
        LangevinDynamicsMove,
        MCDisplacementMove,
        MCMCSampler,
        MonteCarloBarostatMove,
        SequenceMove,
    )
    from openmmtools_tpu_torch.models import LennardJonesFluid
    from openmmtools_tpu_torch.states import ThermodynamicState

    fluid = LennardJonesFluid(nparticles=N, device=dev)
    system = fluid.system
    # rho kT at the default density: the ideal-gas pressure (21.2 bar)
    pressure = (N / fluid.box_edge ** 3) * kB * TEMPERATURE \
        / BAR_TO_KJ_PER_MOL_NM3
    ts = ThermodynamicState(system=system, temperature=TEMPERATURE,
                            pressure=pressure)
    moves = {
        "langevin": LangevinDynamicsMove(timestep=0.002, collision_rate=1.0,
                                         n_steps=5_000),
        "ghmc": GHMCMove(timestep=0.001, n_steps=100),
        "hmc": HMCMove(timestep=0.001, n_inner_steps=10, n_steps=10),
        "displacement": MCDisplacementMove(displacement_sigma=0.1,
                                           atom_subset=[0]),
        "barostat": MonteCarloBarostatMove(volume_scale=0.01, n_attempts=5),
    }
    from openmmtools_tpu_torch.cache import global_context_cache

    # the engine each integrator move binds to, and the context the
    # Metropolized moves evaluate in (the global cache's default Langevin
    # integrator: K1's force kernel on this fluid)
    bounds = {name: moves[name]._bound(ts)
              for name in ("langevin", "ghmc", "hmc")}
    bounds["context"], _ = global_context_cache.get_context(ts)
    assert bounds["langevin"]._fused is not None, "Langevin move off K1"
    assert bounds["context"]._fused is not None, "the moves' context off K1"
    assert bounds["context"] is not bounds["langevin"]
    assert bounds["ghmc"].sweep_mode and bounds["ghmc"]._fused is None
    assert bounds["hmc"].sweep_mode and bounds["hmc"]._fused is None
    wrappers = {"langevin": bounds["langevin"]._fused.launches,
                "ghmc": bounds["ghmc"]._sweep_kernel.launches,
                "hmc": bounds["hmc"]._sweep_kernel.launches,
                "context": bounds["context"]._fused.launches}
    last = {}
    walls = timed_moves(moves, last)
    sampler = MCMCSampler(ts, fluid.sampler_state(),
                          SequenceMove(list(moves.values())))
    for counts in wrappers.values():
        for key in counts:
            counts[key] = 0
    boxes, checks = [], []
    t0 = time.perf_counter()
    with recording() as rec:
        for it in range(MCMC_ITERATIONS):
            sampler.run(1)
            ss = sampler.sampler_state
            boxes.append(float(ss.box_vectors[0, 0]))
            # the moves' own energies at the box each one was handed
            for name in ("langevin", "ghmc", "hmc"):
                st = last[name]
                u_dense = float(ts.potential_energy(
                    bounds[name].sampler_state_from(st)))
                checks.append((it, name, float(st.potentials[0]), u_dense,
                               float(st.box[0, 0])))
        device = rec.span_ms()
        counted = rec.count()
    wall_s = time.perf_counter() - t0
    launches = {name: dict(c) for name, c in wrappers.items()}
    say(f"phase 13a MCMC on LJ-{N} (NPT, {TEMPERATURE} K, {pressure:.3f} "
        f"bar): {MCMC_ITERATIONS} iterations in {wall_s:.2f} s; launches "
        f"{launches}")
    assert launches["langevin"] == {"lj_forces": MCMC_ITERATIONS,
                                    "lj_chunk": MCMC_ITERATIONS}, launches
    # both energies of every displacement and barostat attempt by K1's
    # force kernel: 2 x (1 + 5) an iteration
    context_forces = 2 * (1 + 5) * MCMC_ITERATIONS
    assert launches["context"] == {"lj_forces": context_forces,
                                   "lj_chunk": 0}, launches
    assert counted["lj_forces_f32"] == MCMC_ITERATIONS + context_forces
    for name in ("ghmc", "hmc"):
        assert launches[name]["sweep_bound"] > 0, (name, launches)
        assert launches[name]["sweep_forces"] > 0, (name, launches)
    assert counted["lj_chunk_f32"] == MCMC_ITERATIONS
    assert counted["sweep_forces_f32"] == (launches["ghmc"]["sweep_forces"]
                                           + launches["hmc"]["sweep_forces"])
    baro, ghmc, hmc = moves["barostat"], moves["ghmc"], moves["hmc"]
    disp = moves["displacement"]
    say(f"phase 13a acceptance: barostat {baro.n_accepted}/{baro.n_proposed},"
        f" GHMC {ghmc.n_accepted}/{ghmc.n_proposed}, HMC "
        f"{hmc.n_accepted}/{hmc.n_proposed}, displacement "
        f"{disp.n_accepted}/{disp.n_proposed}; box edge "
        f"{fluid.box_edge:.5f} -> {boxes[-1]:.5f} nm")
    assert baro.n_proposed == 5 * MCMC_ITERATIONS
    assert ghmc.n_accepted > ghmc.n_proposed / 2
    assert hmc.n_proposed == 10 * MCMC_ITERATIONS
    ss = sampler.sampler_state
    assert torch.isfinite(ss.positions).all()
    assert torch.isfinite(ss.velocities).all()
    assert torch.isfinite(ss.box_vectors).all()
    # a changed box reached K1 and sweep mode: each integrator move's final
    # U (from K1's chunk, from K2 and the remainder) against the dense sum
    # at the box it was handed
    moved = [c for c in checks if c[4] != float(system.default_box[0, 0])]
    assert moved, "no barostat acceptance changed the box before a move"
    worst = 0.0
    for it, name, u_run, u_dense, edge in checks:
        rel = abs(u_run - u_dense) / abs(u_dense)
        worst = max(worst, rel)
        assert rel <= REL_TOL, (it, name, u_run, u_dense, edge)
    it, name, u_run, u_dense, edge = checks[-1]
    say(f"phase 13a energies: each move's final U against the dense sum at "
        f"its own box, worst rel {worst:.2e} over {len(checks)} ("
        f"{len(moved)} at a box the barostat changed); last ({name}) U "
        f"{u_run:.4f} vs {u_dense:.4f} at edge {edge:.5f} nm")
    # the median: a move's first apply carries one-time costs (the first
    # dense evaluation on the card)
    per_apply = {name: statistics.median(w) for name, w in walls.items()}
    first = {name: w[0] for name, w in walls.items()}
    k1_ms = device["lj_forces_f32"] + device["lj_chunk_f32"]
    k2_ms = device["sweep_bound_f32"] + device["sweep_forces_f32"]
    say("phase 13a wall ms per apply (median of 10; the first apply): "
        + ", ".join(f"{name} {ms:.2f} ({first[name]:.2f})"
                    for name, ms in per_apply.items()) + f" ({smi})")
    evals = counted["sweep_forces_f32"]
    say(f"phase 13a event spans around each launch (device time plus any "
        f"wait of the card for the host's submission): K1 {k1_ms:.3f} ms "
        f"({k1_ms / MCMC_ITERATIONS:.3f} an apply of the Langevin move: "
        f"lj_chunk {device['lj_chunk_f32']:.3f}, lj_forces "
        f"{device['lj_forces_f32']:.3f}), K2 {k2_ms:.3f} ms (sweep_forces "
        f"{device['sweep_forces_f32']:.3f}, sweep_bound "
        f"{device['sweep_bound_f32']:.3f}) over {evals} evaluations of the "
        f"GHMC and HMC moves ({smi})")
    # K2 at the path's own shapes with the stream held (launch_ms): its
    # launches' device time alone, which the spans above overstate when
    # the host-bound step leaves the card waiting on a short launch
    from openmmtools_tpu_torch.ops import sweep_nb as tsw

    k = bounds["ghmc"]._sweep_kernel
    st = last["ghmc"]
    xT, par, excl, L, _ = tsw.sorted_inputs(system.terms[0], st.positions,
                                            st.box, k)
    flag = torch.tensor(True, device=dev)
    no_flag = torch.tensor(False, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    nb = k.measure_bound(xT, L, flag, zero)
    before = dict(k.launches)
    k2 = {"sweep_forces": launch_ms(lambda: k.sweep(xT, par, excl, L, nb),
                                    "sweep_forces_f32"),
          "sweep_bound_rebuild": launch_ms(
              lambda: k.measure_bound(xT, L, flag, zero), "sweep_bound_f32"),
          "sweep_bound": launch_ms(
              lambda: k.measure_bound(xT, L, no_flag, nb), "sweep_bound_f32")}
    k.launches.update(before)   # the timings' launches are not the path's
    k2_eval = (k2["sweep_forces"] + k2["sweep_bound"],
               k2["sweep_forces"] + k2["sweep_bound_rebuild"])
    per_move = launches["ghmc"]["sweep_forces"] / MCMC_ITERATIONS
    say(f"phase 13a K2 at the GHMC move's final state (bound {int(nb)} "
        f"blocks of {k.n_blocks}), stream held: sweep_forces "
        f"{k2['sweep_forces']:.5f} ms, sweep_bound "
        f"{k2['sweep_bound_rebuild']:.5f} on a rebuild, "
        f"{k2['sweep_bound']:.5f} without; so {k2_eval[0]:.5f}-"
        f"{k2_eval[1]:.5f} ms an evaluation and "
        f"{per_move * k2_eval[0]:.3f}-{per_move * k2_eval[1]:.3f} ms an "
        f"apply of the GHMC or HMC move ({per_move:.0f} evaluations), "
        f"against {k2_ms / evals:.5f} ms an evaluation by the spans ({smi})")
    return sampler, ts, dict(
        wall_ms_per_apply=per_apply, first_apply_ms=first,
        iterations=MCMC_ITERATIONS,
        wall_s=wall_s, launches=launches, span_ms=device,
        k1_span_ms=k1_ms, k2_span_ms=k2_ms, k2_held_ms=k2,
        acceptance={n: [m.n_accepted, m.n_proposed]
                    for n, m in moves.items() if n != "langevin"},
        box_edge=[fluid.box_edge, boxes[-1]], worst_u_rel=worst)


def phase_extras(dev, smi, sampler, ts):
    """13b: the integrators with their own step on LJ-2048 from the MCMC
    run's final state: never K1's chunk, and each one's own physics."""
    from openmmtools_tpu_torch.integrators import (
        AndersenVelocityVerletIntegrator,
        HMCIntegrator,
        MetropolisMonteCarloIntegrator,
    )

    system = ts.system
    ss = sampler.sampler_state
    out = {}
    gen = torch.Generator(device=dev).manual_seed(13)
    with launch_events("lj_chunk_f32") as chunks:
        bound = AndersenVelocityVerletIntegrator(
            temperature=TEMPERATURE, timestep=0.001).bind(system)
        assert bound._fused is None and not bound.sweep_mode
        state = bound.initial_state(ss, gen, thermodynamic_state=ts)
        t = time.perf_counter()
        state = bound.run(state, ANDERSEN_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        temps = []
        for _ in range(10):
            state = bound.run(state, 20)
            temps.append(kinetic_temperature(system.masses, state.velocities,
                                             3 * N))
        mean_t = statistics.fmean(temps)
        say(f"phase 13b Andersen: {ANDERSEN_STEPS} steps in {wall:.2f} s "
            f"({ANDERSEN_STEPS / wall:.1f} steps/s, dense forces; {smi}); "
            f"kinetic temperature {mean_t:.3f} K over 10 samples 20 steps "
            f"apart")
        assert abs(mean_t - TEMPERATURE) < 0.05 * TEMPERATURE
        assert torch.isfinite(state.positions).all()
        out["andersen"] = dict(steps_per_s=ANDERSEN_STEPS / wall,
                               temperature=mean_t)
        for name, integ, steps in (
                ("hmc", HMCIntegrator(temperature=TEMPERATURE, nsteps=10,
                                      timestep=0.001), 10),
                ("metropolis", MetropolisMonteCarloIntegrator(
                    temperature=TEMPERATURE, displacement_sigma=MC_SIGMA),
                 100)):
            bound = integ.bind(system)
            assert bound._fused is None and not bound.sweep_mode
            state = bound.initial_state(ss, gen, thermodynamic_state=ts)
            state = bound.run(state, steps)
            acc, prop = int(state.n_accepted), int(state.n_proposed)
            say(f"phase 13b {type(integ).__name__}: {acc}/{prop} accepted")
            assert prop == steps and acc > 0
            assert torch.isfinite(state.positions).all()
            out[name] = [acc, prop]
        torch.cuda.synchronize()
    assert not chunks.pairs, "an extras integrator launched K1's chunk"
    say("phase 13b: no lj_chunk launch during the extras' runs; each bound "
        "keeps its own step (_fused None, sweep mode off)")
    return out


def phase_water_ghmc(dev, smi):
    """13c: GHMC on explicit solvent (sweep mode, K2, SETTLE inside the
    Metropolized block)."""
    from openmmtools_tpu_torch.mcmc import GHMCMove, MCMCSampler
    from openmmtools_tpu_torch.models import PMEWaterBox

    w = PMEWaterBox(box_edge=WATER_EDGE, device=dev)
    ts = w.thermodynamic_state(WATER_T)
    move = GHMCMove(timestep=0.001, n_steps=WATER_GHMC_STEPS)
    bound = move._bound(ts)
    assert bound.sweep_mode and bound._settle is not None
    k = bound._sweep_kernel
    for key in k.launches:
        k.launches[key] = 0
    last = {}
    walls = timed_moves({"ghmc": move}, last)
    sampler = MCMCSampler(ts, w.sampler_state(), move)
    sampler.run(2)
    launches = dict(k.launches)
    say(f"phase 13c GHMC on PMEWaterBox({WATER_EDGE}): "
        f"{w.system.n_particles} atoms, 2 x {WATER_GHMC_STEPS} steps, "
        f"{move.n_accepted}/{move.n_proposed} accepted; wall ms per apply "
        f"{statistics.fmean(walls['ghmc']):.1f} ({smi}); launches {launches}")
    assert move.n_proposed == 2 * WATER_GHMC_STEPS and move.n_accepted > 0
    assert launches["sweep_bound"] > 0 and launches["sweep_forces"] > 0
    check_final_state(bound, last["ghmc"], "phase 13c")
    return dict(accepted=[move.n_accepted, move.n_proposed],
                wall_ms_per_apply=statistics.fmean(walls["ghmc"]),
                launches=launches)


# -- phase 14: the multistate layer ---------------------------------------------

MS_LAMBDAS = {
    "lambda_electrostatics": [1.0, 0.75, 0.5, 0.25, 0.0, 0.0, 0.0, 0.0, 0.0],
    "lambda_sterics": [1.0, 1.0, 1.0, 1.0, 1.0, 0.75, 0.5, 0.25, 0.0]}
MS_STEPS = 50
MS_ITERATIONS = 3
MS_FIRE_STEPS = 20
SAMS_ITERATIONS = 6
PT_STEPS = 5_000
PT_ITERATIONS = 5
PT_LADDER = dict(min_temperature=120.0, max_temperature=180.0,
                 n_temperatures=8)


def storage_modules():
    """Whether h5py and PyYAML import here (the reporter's needs), and the
    error where they do not."""
    try:
        import h5py  # noqa: F401
        import yaml  # noqa: F401
    except ImportError as e:
        return False, str(e)
    return True, None


def ladder_states(system):
    from openmmtools_tpu_torch.alchemy import AlchemicalState
    from openmmtools_tpu_torch.states import (
        CompoundThermodynamicState,
        ThermodynamicState,
        create_thermodynamic_state_protocol,
    )

    ref = CompoundThermodynamicState(
        base_state=ThermodynamicState(system=system, temperature=WATER_T),
        composable_states=(AlchemicalState(lambda_electrostatics=1.0,
                                           lambda_sterics=1.0),))
    return create_thermodynamic_state_protocol(ref, MS_LAMBDAS)


def water_move():
    from openmmtools_tpu_torch.mcmc import LangevinSplittingDynamicsMove

    return LangevinSplittingDynamicsMove(timestep=0.002, collision_rate=1.0,
                                         n_steps=MS_STEPS,
                                         splitting="V R O R V")


def split_means(sampler, first):
    """Mean seconds an iteration of each phase from iteration ``first``."""
    return {name: statistics.fmean(v[first:])
            for name, v in sampler.phase_seconds.items()}


def matrix_against_plain(bound, sampler, pairs):
    """u[n, k] of the sampler's last matrix against beta_k U of the plain
    sweep plus the remainder at state k's parameters (a fresh sort of
    replica n): the largest relative error over ``pairs``."""
    from openmmtools_tpu_torch.ops import sweep_nb as tsw

    k = bound._sweep_kernel
    u = sampler.energies_last_iteration
    beta = sampler._stacked_states.beta.numpy()
    worst = 0.0
    bound._sweep_kernel = tsw.PlainSweepNonbonded.like(k)
    try:
        for n, col in pairs:
            ss = sampler.sampler_states[n]
            params = sampler._params_on(ss.positions.device,
                                        ss.positions.dtype)[col]
            U = float(bound.energies_at(ss.positions, ss.box_vectors,
                                        [params])[0])
            rel = float(abs(u[n, col] - beta[col] * U) / abs(beta[col] * U))
            say(f"phase 14a u[{n}, {col}] {u[n, col]:.4f} vs plain "
                f"{beta[col] * U:.4f} (rel {rel:.2e})")
            worst = max(worst, rel)
    finally:
        bound._sweep_kernel = k
    assert worst <= REL_TOL, worst
    return worst


def k2_held_ms(bound, sampler, dev):
    """K2's two kernels at the path's shapes with the stream held
    (launch_ms): replica 0's final state at its state's lambdas."""
    k = bound._sweep_kernel
    term = bound._sweep_alch
    ss = sampler.sampler_states[0]
    s0 = int(sampler.replica_states[0])
    params = sampler._params_on(ss.positions.device, ss.positions.dtype)[s0]
    xT, par, excl, L, lam = alchemical_inputs(term, ss.positions,
                                              ss.box_vectors, k, params)
    flag = torch.tensor(True, device=dev)
    no_flag = torch.tensor(False, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    nb = k.measure_bound(xT, L, flag, zero)
    before = dict(k.launches)
    held = {"sweep_forces_alch": launch_ms(
                lambda: k.sweep(xT, par, excl, L, nb, lam),
                "sweep_forces_alch_f32"),
            "sweep_bound_rebuild": launch_ms(
                lambda: k.measure_bound(xT, L, flag, zero), "sweep_bound_f32"),
            "sweep_bound": launch_ms(
                lambda: k.measure_bound(xT, L, no_flag, nb),
                "sweep_bound_f32")}
    k.launches.update(before)   # the timings' launches are not the path's
    return held, int(nb)


def phase_multistate_re(dev, smi):
    """14a: replica exchange over the lambda ladder on the water box."""
    from openmmtools_tpu_torch.models import AlchemicalWaterBox
    from openmmtools_tpu_torch.multistate import (
        MultiStateReporter,
        ReplicaExchangeAnalyzer,
        ReplicaExchangeSampler,
        mbar_free_energies,
    )

    w = AlchemicalWaterBox(box_edge=WATER_EDGE, device=dev)
    system = w.system
    states = ladder_states(system)
    n_states = len(states)
    move = water_move()
    bound = move._bound(states[0])
    assert bound.sweep_mode and bound._sweep_alch is not None, \
        "sweep mode did not take the alchemical term"
    assert bound._settle is not None and bound._fused is None
    k = bound._sweep_kernel
    assert set(k.launches) == {"sweep_bound", "sweep_forces_alch"}
    finals = []
    move._on_integration_end = finals.append
    have_storage, why = storage_modules()
    tmp = tempfile.TemporaryDirectory()
    reporter = None
    if have_storage:
        reporter = MultiStateReporter(
            str(pathlib.Path(tmp.name) / "re.h5"), checkpoint_interval=1)
    else:
        say(f"phase 14a storage: the reporter is not driven on the card "
            f"({why}); the CPU tests hold it")
    sampler = ReplicaExchangeSampler(
        mcmc_moves=move, number_of_iterations=MS_ITERATIONS,
        online_analysis_interval=None, replica_mixing_scheme="swap-all",
        rng_seed=14)
    t0 = time.perf_counter()
    sampler.create(states, w.sampler_state(), storage=reporter)
    t_create = time.perf_counter() - t0
    t0 = time.perf_counter()
    sampler.minimize(max_iterations=MS_FIRE_STEPS)
    t_min = time.perf_counter() - t0
    n = sampler.n_replicas
    assert n == n_states == 9
    say(f"phase 14a setup: {system.n_particles} atoms, {n_states} states, "
        f"{n} replicas; create (the initial 9 x 9 matrix) {t_create:.2f} s, "
        f"FIRE ({MS_FIRE_STEPS} steps a replica, sweep forces, SETTLE) "
        f"{t_min:.2f} s")
    for key in k.launches:
        k.launches[key] = 0
    t0 = time.perf_counter()
    sampler.run(MS_ITERATIONS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(k.launches)
    per_iteration = n * (MS_STEPS + 1) + n * n_states
    say(f"phase 14a {MS_ITERATIONS} iterations in {wall:.2f} s; K2 "
        f"launches {launches} (expected {per_iteration} of each an "
        f"iteration: {n} x {MS_STEPS + 1} propagation + {n * n_states} "
        f"matrix evaluations)")
    assert launches == {"sweep_bound": MS_ITERATIONS * per_iteration,
                        "sweep_forces_alch": MS_ITERATIONS * per_iteration}, \
        launches
    u = sampler.energies_last_iteration
    s = sampler.replica_states
    assert u.shape == (n, n_states) and np.isfinite(u).all()
    worst = matrix_against_plain(bound, sampler, [(0, n_states - 1), (4, 2)])
    # u[n, s_n] against beta U of each replica's own final integrator state
    beta = sampler._stacked_states.beta.numpy()
    own = 0.0
    for r, st in enumerate(finals[-n:]):
        u_run = beta[s[r]] * float(st.potentials[0])
        own = max(own, float(abs(u[r, s[r]] - u_run) / abs(u_run)))
    say(f"phase 14a u[n, s_n] against beta U of each replica's final "
        f"integrator state: worst rel {own:.2e}")
    assert own <= REL_TOL, own
    acc = sampler._n_accepted.numpy()
    prop = sampler._n_proposed.numpy()
    assert (prop == prop.T).all() and (acc == acc.T).all()
    assert prop.sum() > 0
    say(f"phase 14a swaps: {int(acc.sum()) // 2} of {int(prop.sum()) // 2} "
        f"accepted; replica states {s.tolist()}")
    hist_u = np.stack(sampler._energy_history)        # (T + 1, N, K)
    hist_s = np.stack(sampler._state_history)
    u_ln = hist_u.reshape(-1, n_states).T
    n_k = np.bincount(hist_s.reshape(-1), minlength=n_states)
    result = mbar_free_energies(u_ln, n_k)
    f = result.free_energies.numpy()
    assert np.isfinite(f).all(), f
    say(f"phase 14a MBAR over the {hist_u.shape[0]} in-memory iterations: "
        f"f_k {np.round(f, 3).tolist()} kT")
    analyzed = None
    if have_storage:
        reporter.close()
        analyzer = ReplicaExchangeAnalyzer(
            MultiStateReporter(reporter.storage_path),
            n_equilibration_iterations=0, statistical_inefficiency=1.0)
        df, _ = analyzer.get_free_energy()
        rel = float(np.abs(df[0] - (f - f[0])).max()
                    / np.abs(f - f[0]).max())
        say(f"phase 14a storage: the analyzer on the stored run, Delta f "
            f"against the in-memory MBAR: rel {rel:.2e}")
        assert rel <= 1e-10, rel
        analyzer.reporter.close()
        analyzed = rel
    tmp.cleanup()
    split = split_means(sampler, 0)
    it_s = wall / MS_ITERATIONS
    ns_day = n * MS_STEPS * 0.002e-3 / it_s * 86400.0
    held, nb = k2_held_ms(bound, sampler, dev)
    k2_lo = per_iteration * (held["sweep_forces_alch"] + held["sweep_bound"])
    k2_hi = per_iteration * (held["sweep_forces_alch"]
                             + held["sweep_bound_rebuild"])
    say(f"phase 14a {it_s:.3f} s an iteration ({ns_day:.3f} ns/day over "
        f"the {n} replicas): mixing {split['mixing']:.4f} s, propagation "
        f"{split['propagation']:.3f} s, energy matrix "
        f"{split['energy_matrix']:.3f} s, reporting {split['reporting']:.4f}"
        f" s ({smi})")
    say(f"phase 14a K2 at replica 0's final state (bound {nb} blocks), "
        f"stream held: sweep_forces_alch {held['sweep_forces_alch']:.5f} ms, "
        f"sweep_bound {held['sweep_bound_rebuild']:.5f} on a rebuild, "
        f"{held['sweep_bound']:.5f} without; so {k2_lo:.2f}-{k2_hi:.2f} ms "
        f"of K2 device time an iteration ({per_iteration} evaluations; "
        f"{smi})")
    return sampler, dict(
        atoms=system.n_particles, states=n_states, replicas=n,
        iterations=MS_ITERATIONS, steps_per_iteration=MS_STEPS,
        seconds_per_iteration=it_s, ns_per_day=ns_day, split_s=split,
        create_s=t_create, minimize_s=t_min, launches=launches,
        matrix_worst_rel=worst, own_state_worst_rel=own,
        swaps=[int(acc.sum()) // 2, int(prop.sum()) // 2],
        k2_held_ms=held, k2_ms_per_iteration=[k2_lo, k2_hi],
        storage_rel=analyzed, storage=("driven" if have_storage else why))


def phase_multistate_sams(dev, smi, re_sampler):
    """14b: single-replica SAMS on the same box and ladder, from the RE
    run's replica 0."""
    from openmmtools_tpu_torch.multistate import SAMSSampler

    system = re_sampler._thermodynamic_states[0].system
    states = ladder_states(system)
    move = water_move()
    bound = move._bound(states[0])
    assert bound.sweep_mode and bound._sweep_alch is not None
    k = bound._sweep_kernel
    sampler = SAMSSampler(
        mcmc_moves=move, number_of_iterations=SAMS_ITERATIONS,
        state_update_scheme="global-jump", online_analysis_interval=None,
        rng_seed=15)
    sampler.create(states, [re_sampler.sampler_states[0]],
                   initial_thermodynamic_states=[0])
    assert sampler.n_replicas == 1
    for key in k.launches:
        k.launches[key] = 0
    t0 = time.perf_counter()
    sampler.run(SAMS_ITERATIONS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(k.launches)
    per_iteration = (MS_STEPS + 1) + len(states)
    hist = sampler._histogram
    logZ = sampler.logZ
    say(f"phase 14b SAMS: {SAMS_ITERATIONS} iterations in {wall:.2f} s "
        f"({1e3 * wall / SAMS_ITERATIONS:.1f} ms an iteration; {smi}); "
        f"visits {hist.tolist()}, logZ {np.round(logZ, 3).tolist()}, stage "
        f"{sampler._stage}; K2 launches {launches}")
    assert launches == {"sweep_bound": SAMS_ITERATIONS * per_iteration,
                        "sweep_forces_alch":
                        SAMS_ITERATIONS * per_iteration}, launches
    assert hist.sum() == SAMS_ITERATIONS and np.isfinite(hist).all()
    assert np.isfinite(logZ).all()
    assert np.isfinite(sampler.energies_last_iteration).all()
    return dict(iterations=SAMS_ITERATIONS,
                ms_per_iteration=1e3 * wall / SAMS_ITERATIONS,
                visits=hist.tolist(), logZ=logZ.tolist(), launches=launches)


def phase_multistate_pt(dev, smi):
    """14c: parallel tempering on LJ-2048 through K1's fused chunk."""
    from openmmtools_tpu_torch.mcmc import LangevinDynamicsMove
    from openmmtools_tpu_torch.models import LennardJonesFluid
    from openmmtools_tpu_torch.multistate import ParallelTemperingSampler

    fluid = LennardJonesFluid(nparticles=N, device=dev)
    ts = fluid.thermodynamic_state(PT_LADDER["min_temperature"])
    move = LangevinDynamicsMove(timestep=0.002, collision_rate=1.0,
                                n_steps=PT_STEPS)
    finals = []
    move._on_integration_end = finals.append
    sampler = ParallelTemperingSampler(
        mcmc_moves=move, number_of_iterations=PT_ITERATIONS,
        online_analysis_interval=None, replica_mixing_scheme="swap-neighbors",
        rng_seed=16)
    sampler.create(ts, fluid.sampler_state(), **PT_LADDER)
    n = sampler.n_replicas
    bounds = [move._bound(st) for st in sampler._thermodynamic_states]
    assert all(b._fused is not None for b in bounds), "a PT move is off K1"
    for b in bounds:
        for key in b._fused.launches:
            b._fused.launches[key] = 0
    t0 = time.perf_counter()
    sampler.run(PT_ITERATIONS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {key: sum(b._fused.launches[key] for b in bounds)
                for key in ("lj_forces", "lj_chunk")}
    temps = [round(float(t), 3) for t in sampler._stacked_sampled.temperature]
    say(f"phase 14c PT on LJ-{N}, temperatures {temps} K: {PT_ITERATIONS} "
        f"iterations of {PT_STEPS} steps in {wall:.2f} s "
        f"({1e3 * wall / PT_ITERATIONS:.1f} ms an iteration; {smi}); K1 "
        f"launches {launches}")
    assert launches == {"lj_forces": n * PT_ITERATIONS,
                        "lj_chunk": n * PT_ITERATIONS}, launches
    u = sampler.energies_last_iteration
    s = sampler.replica_states
    assert np.isfinite(u).all()
    # the O(N) matrix against each state's dense reduced potential, and the
    # replicas' own columns against K1's final energies
    worst = own = 0.0
    beta = sampler._stacked_sampled.beta.numpy()
    for r, ss in enumerate(sampler.sampler_states):
        for col, st in enumerate(sampler._thermodynamic_states):
            dense = float(st.reduced_potential(ss))
            worst = max(worst, float(abs(u[r, col] - dense) / abs(dense)))
        u_run = beta[s[r]] * float(finals[-n:][r].potentials[0])
        own = max(own, float(abs(u[r, s[r]] - u_run) / abs(u_run)))
    acc = sampler._n_accepted.numpy()
    prop = sampler._n_proposed.numpy()
    say(f"phase 14c O(N) energies against the dense reduced potential: "
        f"worst rel {worst:.2e}; u[n, s_n] against K1's final U: worst rel "
        f"{own:.2e}; swaps {int(acc.sum()) // 2} of {int(prop.sum()) // 2}")
    assert worst <= 1e-5 and own <= REL_TOL, (worst, own)
    return dict(temperatures=temps, iterations=PT_ITERATIONS,
                steps_per_iteration=PT_STEPS,
                ms_per_iteration=1e3 * wall / PT_ITERATIONS,
                launches=launches, dense_worst_rel=worst,
                own_state_worst_rel=own)


# -- phase 15: the equilibration path -----------------------------------------

EQ_MIN_ITERATIONS = 200
EQ_STEPS = 500
EQ_SIGMA = 0.3           # nm: the oxygens' positional restraint
EQ_PRESSURE = 1.0        # bar
PT_WATER_TEMPERATURES = [300.0, 310.0, 320.0, 330.0]
PT_WATER_STEPS = 50


def equilibration_stages(n_atoms):
    from openmmtools_tpu_torch.utils.equilibration import EquilibrationStage

    oxygens = list(range(0, n_atoms, 3))
    restrained = dict(restraint_sigma=EQ_SIGMA, restrained_atoms=oxygens)
    dynamics = dict(temperature=WATER_T, n_steps=EQ_STEPS, timestep=0.001,
                    collision_rate=10.0)
    return [
        EquilibrationStage(stage_type="minimize",
                           n_steps=EQ_MIN_ITERATIONS, **restrained),
        EquilibrationStage(stage_type="nvt", **dynamics, **restrained),
        EquilibrationStage(stage_type="npt", pressure=EQ_PRESSURE,
                           **dynamics, **restrained),
        EquilibrationStage(stage_type="npt", pressure=EQ_PRESSURE,
                           **dynamics),
    ]


def bond_error(system, x, box):
    c = system.constraints
    i, j = c.index[:, 0].long(), c.index[:, 1].long()
    L = torch.diagonal(box)
    d = x[i] - x[j]
    d = d - L * torch.round(d / L)
    return float(((torch.linalg.norm(d, dim=1) - c.distance)
                  / c.distance).abs().max())


def plain_energies(bound, sampler_states, params):
    """U of each sampler state at its box by the plain sweep plus the
    remainder (the bound's path with its kernel swapped for the plain
    version: a fresh sort, a full rebuild)."""
    from openmmtools_tpu_torch.ops import sweep_nb as tsw

    k = bound._sweep_kernel
    bound._sweep_kernel = tsw.PlainSweepNonbonded.like(k)
    try:
        return [float(bound.energies_at(ss.positions, ss.box_vectors,
                                        [params])[0])
                for ss in sampler_states]
    finally:
        bound._sweep_kernel = k


def phase_equilibration(dev, smi):
    """15a: run_gentle_equilibration on the JAC water box, every energy and
    force through K2 in sweep mode (no dense route can complete: the
    thermodynamic state's dense energy raises at this size)."""
    from openmmtools_tpu_torch.cache import ContextCache
    from openmmtools_tpu_torch.forces import PositionalRestraintTerm
    from openmmtools_tpu_torch.mcmc import (
        MonteCarloBarostatMove,
        potential_energies,
    )
    from openmmtools_tpu_torch.models import PMEWaterBox
    from openmmtools_tpu_torch.ops import sweep_nb as tsw
    from openmmtools_tpu_torch.system import volume
    from openmmtools_tpu_torch.utils import Timer
    from openmmtools_tpu_torch.utils.equilibration import (
        barostat_applies,
        run_gentle_equilibration,
    )

    w = PMEWaterBox(box_edge=WATER_EDGE, device=dev)
    system = w.system
    n = system.n_particles
    ts = w.thermodynamic_state(WATER_T)
    try:
        ts.potential_energy(w.sampler_state())
    except RuntimeError as e:
        say(f"phase 15a the dense sum refuses: {e}")
    else:
        raise AssertionError("the dense sum served a 24,000-atom system")
    stages = equilibration_stages(n)
    cache = ContextCache()
    timer = Timer()
    ends = []
    attempts = []
    attempt = MonteCarloBarostatMove.attempt

    def timed_attempt(self, *args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = attempt(self, *args, **kwargs)
        accepted = bool(out[1])
        attempts.append((1e3 * (time.perf_counter() - t), accepted))
        return out

    def at_stage_end(i, stage, ss):
        torch.cuda.synchronize()
        ends.append(ss)

    start = w.sampler_state()
    MonteCarloBarostatMove.attempt = timed_attempt
    try:
        t0 = time.perf_counter()
        out = run_gentle_equilibration(ts, start, stages, seed=15,
                                       context_cache=cache, timer=timer,
                                       callback=at_stage_end)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        MonteCarloBarostatMove.attempt = attempt
    seconds = timer.report_timing()
    bounds = cache.bound_integrators()
    assert len(bounds) == 4, len(bounds)
    launches = [dict(b._sweep_kernel.launches) for b in bounds]
    applies = [barostat_applies(st) if st.stage_type == "npt" else 0
               for st in stages]
    expected = [EQ_MIN_ITERATIONS + 3] + [
        st.n_steps + 1 + 2 * a for st, a in zip(stages[1:], applies[1:])]
    say(f"phase 15a run_gentle_equilibration on PMEWaterBox({WATER_EDGE}) "
        f"({n} atoms, {n // 3} oxygens restrained at sigma {EQ_SIGMA} nm in "
        f"stages 1-3): {wall:.2f} s; K2 launches by stage {launches} "
        f"(expected {expected} of each: FIRE one an iteration + its final "
        f"energy + the acceptance check's two; dynamics n_steps + 1; two a "
        f"barostat attempt)")
    for b, restrained in zip(bounds, (True, True, True, False)):
        assert b.sweep_mode and b._fused is None and b._settle is not None
        assert b._sweep_alch is None
        leftover = [type(t) for t in b._sweep_leftover]
        assert (PositionalRestraintTerm in leftover) == restrained, leftover
    for got, want in zip(launches, expected):
        assert got == {"sweep_bound": want, "sweep_forces": want}, launches
    # the restrained minimum below the start's energy, on stage 1's own
    # bound integrator (its restraint about the start)
    u_start, u_min = (float(u) for u in potential_energies(
        water_state(bounds[0].system), (start, ends[0]), cache))
    say(f"phase 15a minimize: restrained U {u_start:.2f} -> {u_min:.2f} "
        f"kJ/mol in {EQ_MIN_ITERATIONS} FIRE iterations")
    assert u_min < u_start
    for i, ss in enumerate(ends):
        assert torch.isfinite(ss.positions).all()
        assert torch.isfinite(ss.box_vectors).all()
        geom = bond_error(system, ss.positions, ss.box_vectors)
        say(f"phase 15a stage {i + 1} ({stages[i].stage_type}): set-up "
            f"{seconds[f'stage {i} setup']:.2f} s, run "
            f"{seconds[f'stage {i} run']:.2f} s; max relative bond-length "
            f"error {geom:.2e}; box edge {float(ss.box_vectors[0, 0]):.5f} "
            f"nm")
        assert geom <= 1e-5, (i, geom)
    dof = 3 * n - system.constraints.n_constraints
    t_last = kinetic_temperature(system.masses, out.velocities, dof)
    v0 = float(volume(start.box_vectors))
    v1 = float(volume(out.box_vectors))
    acc = sum(a for _, a in attempts)
    ms = [m for m, _ in attempts]
    ns_day = {i + 1: stages[i].n_steps * stages[i].timestep * 1e-3
              / seconds[f"stage {i} run"] * 86400.0 for i in (1, 2, 3)}
    say(f"phase 15a last stage kinetic temperature {t_last:.2f} K; volume "
        f"{v0:.4f} -> {v1:.4f} nm^3; barostat {acc}/{len(attempts)} "
        f"accepted, {statistics.median(ms):.2f} ms an attempt (median; "
        f"first {ms[0]:.2f}); ns/day of stages 2-4 (dynamics and barostat) "
        f"{ {k: round(v, 3) for k, v in ns_day.items()} } ({smi})")
    assert len(attempts) == sum(applies)
    assert abs(t_last - WATER_T) <= 0.05 * WATER_T, t_last
    # one barostat attempt's two energies against the plain sweep plus the
    # remainder at the same boxes (stage 4's context, its final state and
    # a trial 1 % larger in volume)
    last = bounds[-1]
    ts4 = water_state(last.system, pressure=EQ_PRESSURE)
    baro = MonteCarloBarostatMove()
    mol_ids, n_mol = baro._molecules_for(last.system)
    eps = torch.tensor(0.01, dtype=out.positions.dtype, device=dev)
    trial, _ = baro.attempt(ts4, out, eps, torch.tensor(-1e30, device=dev),
                            mol_ids, n_mol, cache)
    pair = (out, trial)
    u_k2 = [float(u) for u in potential_energies(ts4, pair, cache)]
    u_plain = plain_energies(last, pair, {})
    rel = max(abs(a - b) / abs(b) for a, b in zip(u_k2, u_plain))
    say(f"phase 15a a barostat attempt's u_old, u_new by K2 "
        f"{u_k2[0]:.3f}, {u_k2[1]:.3f} vs the plain sweep plus the "
        f"remainder {u_plain[0]:.3f}, {u_plain[1]:.3f} (rel {rel:.2e})")
    assert rel <= REL_TOL, rel
    # K2's held device time in an attempt: two fresh sorts, each a rebuild
    k = last._sweep_kernel
    xT, par, excl, L, _ = tsw.sorted_inputs(last._sweep_term, out.positions,
                                            out.box_vectors, k)
    flag = torch.tensor(True, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    nb = k.measure_bound(xT, L, flag, zero)
    before = dict(k.launches)
    held = {"sweep_forces": launch_ms(lambda: k.sweep(xT, par, excl, L, nb),
                                      "sweep_forces_f32"),
            "sweep_bound_rebuild": launch_ms(
                lambda: k.measure_bound(xT, L, flag, zero),
                "sweep_bound_f32")}
    k.launches.update(before)
    k2_attempt = 2 * (held["sweep_forces"] + held["sweep_bound_rebuild"])
    say(f"phase 15a K2 at the final state, stream held: sweep_forces "
        f"{held['sweep_forces']:.5f} ms, sweep_bound on a rebuild "
        f"{held['sweep_bound_rebuild']:.5f} ms; so {k2_attempt:.4f} ms of "
        f"K2 device time in a barostat attempt of "
        f"{statistics.median(ms):.2f} ms ({smi})")
    # the float32 trial's projection onto the constraints (SETTLE), wall
    # time with the card synchronized around each call
    project = []
    for _ in range(20):
        torch.cuda.synchronize()
        t = time.perf_counter()
        last._constrain_positions(trial.positions, out.positions)
        torch.cuda.synchronize()
        project.append(1e3 * (time.perf_counter() - t))
    say(f"phase 15a the trial's projection onto the constraints (SETTLE) "
        f"{statistics.median(project):.3f} ms of an attempt (median of 20, "
        f"synchronized) ({smi})")
    return dict(
        atoms=n, wall_s=wall,
        setup_s=[seconds[f"stage {i} setup"] for i in range(4)],
        run_s=[seconds[f"stage {i} run"] for i in range(4)],
        launches=launches, restrained_u=[u_start, u_min],
        last_temperature=t_last, volume=[v0, v1],
        barostat=[acc, len(attempts)],
        barostat_ms_median=statistics.median(ms), ns_per_day=ns_day,
        k2_held_ms=held, k2_ms_per_attempt=k2_attempt,
        project_ms=statistics.median(project), attempt_rel=rel)


def water_state(system, pressure=None):
    """The thermodynamic state of a water system at 300 K."""
    from openmmtools_tpu_torch.states import ThermodynamicState

    return ThermodynamicState(system=system, temperature=WATER_T,
                              pressure=pressure)


def phase_pt_water(dev, smi):
    """15b: parallel tempering on the JAC water box: each replica's move and
    the O(N) energies through K2 (no dense route)."""
    from openmmtools_tpu_torch.mcmc import LangevinDynamicsMove
    from openmmtools_tpu_torch.models import PMEWaterBox
    from openmmtools_tpu_torch.multistate import ParallelTemperingSampler

    w = PMEWaterBox(box_edge=WATER_EDGE, device=dev)
    move = LangevinDynamicsMove(timestep=0.002, collision_rate=1.0,
                                n_steps=PT_WATER_STEPS)
    sampler = ParallelTemperingSampler(
        mcmc_moves=move, number_of_iterations=1,
        online_analysis_interval=None, replica_mixing_scheme="swap-neighbors",
        rng_seed=17)
    t0 = time.perf_counter()
    sampler.create(w.thermodynamic_state(WATER_T), w.sampler_state(),
                   temperatures=PT_WATER_TEMPERATURES)
    sampler.minimize(max_iterations=MS_FIRE_STEPS)
    t_setup = time.perf_counter() - t0
    n = sampler.n_replicas
    bounds = [move._bound(st) for st in sampler._thermodynamic_states]
    kernels = {id(b._sweep_kernel): b._sweep_kernel for b in bounds}
    assert all(b.sweep_mode and b._fused is None for b in bounds)
    for k in kernels.values():
        for key in k.launches:
            k.launches[key] = 0
    t0 = time.perf_counter()
    sampler.run(1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {key: sum(k.launches[key] for k in kernels.values())
                for key in ("sweep_bound", "sweep_forces")}
    want = n * (PT_WATER_STEPS + 1) + n
    say(f"phase 15b PT on PMEWaterBox({WATER_EDGE}), temperatures "
        f"{PT_WATER_TEMPERATURES} K, {n} replicas x {PT_WATER_STEPS} steps: "
        f"set-up (create, FIRE) {t_setup:.2f} s, one iteration {wall:.2f} s "
        f"({smi}); K2 launches {launches} (expected {want} of each: "
        f"{n} x {PT_WATER_STEPS + 1} propagation + {n} O(N) energies)")
    assert launches == {"sweep_bound": want, "sweep_forces": want}, launches
    u = sampler.energies_last_iteration
    assert u.shape == (n, n) and np.isfinite(u).all()
    beta = sampler._stacked_sampled.beta.numpy()
    worst = 0.0
    for r in (0, n - 1):
        ss = sampler.sampler_states[r]
        (U,) = plain_energies(sampler._matrix_bound(), [ss], {})
        worst = max(worst, max(abs(u[r, c] - beta[c] * U) / abs(beta[c] * U)
                               for c in range(n)))
    say(f"phase 15b the O(N) columns against the plain sweep plus the "
        f"remainder: worst rel {worst:.2e}")
    assert worst <= REL_TOL, worst
    return dict(replicas=n, steps=PT_WATER_STEPS, setup_s=t_setup,
                iteration_s=wall, launches=launches, worst_rel=worst)


def main():
    name, smi = phase_device()
    dev = torch.device("cuda")
    phase_build()
    k = phase_kernels(dev)
    phase_noise(dev)
    kernels, rate = phase_main_path(dev, smi, k)
    k6 = phase_sweep_kernels(dev)
    water_kernels, water_rate = phase_water(dev, smi, k6)
    k8 = phase_alchemical_kernels(dev, smi)
    alch_kernel, state_a, system_a, alch_rate = phase_alchemical_path(
        dev, smi, k8)
    ncmc = phase_ncmc(dev, smi, state_a, system_a)
    dense_kernel, dense_rate = phase_dense(dev, smi, k)
    cell_kernels, cell_rate = phase_cell(dev, smi)
    sampler, ts, mcmc = phase_mcmc(dev, smi)
    mcmc["extras"] = phase_extras(dev, smi, sampler, ts)
    mcmc["water_ghmc"] = phase_water_ghmc(dev, smi)
    re_sampler, multistate = phase_multistate_re(dev, smi)
    multistate["sams"] = phase_multistate_sams(dev, smi, re_sampler)
    multistate["pt"] = phase_multistate_pt(dev, smi)
    equilibration = phase_equilibration(dev, smi)
    equilibration["pt_water"] = phase_pt_water(dev, smi)
    say(json.dumps({"lj_path": rate, "explicit_solvent_path": water_rate,
                    "alchemical_path": alch_rate, "ncmc_path": ncmc,
                    "alchemical_kernel_worst": k8, "dense_path": dense_rate,
                    "cell_path": cell_rate, "mcmc_path": mcmc,
                    "multistate_path": multistate,
                    "equilibration_path": equilibration, "card": smi}))
    print(json.dumps({"kernels": kernels + water_kernels + [alch_kernel]
                      + [dense_kernel] + cell_kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
