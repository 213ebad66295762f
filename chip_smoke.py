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
   (sweep mode, SETTLE) -> initial_state -> run, warmed up for 1,000 steps
   and timed in 1,000-step chunks that each end in a host fetch of the
   positions; launch counts, steps/s and ns/day, the kinetic temperature
   (after the chunks: 4,000 steps or more from the lattice start), the
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
   lambda, 250 steps, 'O { V R H R V } O') for one whole protocol, and a
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
   sweep mode with K2's alchemical kernel and SETTLE, the batched route,
   K2's launches an iteration (51 propagation evaluations of the 9
   replicas and one of the 81 pairs of the energy matrix, each a bound
   and a force launch, 52 of each; by batch size), the matrix finite, two
   of its
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
   one a barostat attempt, its two configurations as one batch), the
   restrained minimum below the start, the
   rigid geometry and a finite box after every stage, the last stage's
   kinetic temperature within 5 %, one barostat attempt's two energies
   against the plain sweep plus the remainder; set-up and run seconds a
   stage, ms a barostat attempt, K2's held device ms and the float32
   trial's projection onto the constraints in it, the acceptances, the
   volume, ns/day; (b) parallel tempering on the same box
   (4 temperatures from 300 to 330 K, LangevinDynamicsMove 2 fs x 50
   steps, one iteration from a FIRE-minimized state): the batched route,
   K2's launches 50 + 1 + 1 of each (the 4 replicas together), the O(N)
   columns against the plain sweep plus the remainder;
16. the rest of the catalog: (a) ``scripts.test_platforms.run_sweep`` on
   the card over every system of ``get_available_testsystems()`` less
   ``_SLOW``, each built by its default constructor: cuda/f32 and cpu/f32
   against cpu/f64 (0.06 kcal/mol, ``FORCE_RTOL``) and, wherever K1's fused
   path or K2's sweep engages, the kernel check against the dense float32
   sum with each kernel's launches read from its counter; no failure, the
   names checked the catalog less ``_SLOW`` less the named skips, and which
   systems took K1, K2, K2's alchemical variant or none; (b)
   CustomGBForceSystem() (140 atoms, GBSA-OBC) on the generic program,
   BAOAB 300 K, 1/ps, 1 fs (its ion pairs' contact vibration leaves 2 fs
   unstable) for 1,000 steps, the final U and F against CPU
   float64, ms a step, and the factory's alchemical version (the first
   molecule) at lambda_electrostatics 0, 0.5 and 1 against CPU float64;
   (c) CustomGBForceSystem(n_molecules=1024) (2,048 atoms) in sweep mode
   with the GB term in the sweep's remainder: the initial U and F against
   the dense float32 sum, 200 steps of 1 fs and K2's launches; (d)
   neighbour mode at its threshold on the card, LennardJonesFluid(100,000) on a lattice
   at the catalog's density, BAOAB 120 K with sweep off: k_max, r_list
   and the rebuild interval, two intervals with no overflow, the final U
   against a float64 recomputation over a fresh blocked list and against
   K2's energy (a second bind in forced sweep mode), ms a rebuild and a
   step; (e) ``scripts.benchmark_alchemy.main([])`` (512 particles, 100
   iterations) and its µs an evaluation;
17. replicas as one batched axis: (a) K2's replica axis at the main
   paths' shapes: the ladder's 9 final replicas as one batch of 9 (each
   at its state's lambdas) and the matrix's 81 (replica, state) pairs on
   the 9 sort sets, the standard variant on 4 configurations of
   PMEWaterBox(6.223): each launch twice for the same bits, against
   single launches for the same bits and against the plain version, the
   bound pass over the 9 sets on a rebuild; device ms of a batched launch
   beside a single one and the bound of B evaluations; (b) the eager loop
   on the ladder through a tree that cannot batch (a SequenceMove of the
   Langevin move, 10 steps, and a displacement wrapped in a move that
   implements only ``_apply``), while the same SequenceMove unwrapped
   takes the batched route; (c) 3 replicas
   of the ladder, 50 steps, batched and one by one with the same
   generators: the final U and F (2e-4); (d)
   ``scripts.demo_free_energy.main`` at a cut depth (``DEMO_CUT``): exit
   0, the three routes within 6 sigma, seconds a route; (e)
   ``parallel.atom_shard`` on PMEWaterBox(3.6), 5,184 atoms, over 4
   blocks on the card, against the bound integrator's energy and forces;
18. the Amber loader, in a temporary data directory that
   ``models.amber.DEFAULT_DATA_DIR`` points at: (a) prmtops written here
   (``write_prmtop``): the water-only one of PMEWaterBox(6.223), the
   JAC-size stand-in (40 all-trans eicosanes in that box's waters less
   those within 0.25 nm, GAFF c3/hc parameters; not DHFR) at
   dhfr/JAC.prmtop + system.pdb, a vacuum hexane at
   alanine-dipeptide-gbsa/, and the pure-Python parse of the stand-in
   timed; (b) the loader's water system against PMEWaterBox(6.223) on K2:
   U and F whole, of the reciprocal term (float64) and of the direct
   space; (c) the slice's main path: DHFRExplicit(data_dir=<stand-in>) ->
   BAOABIntegrator(300 K, 1/ps, 2 fs) -> bind (sweep mode with K2's
   standard variant, SETTLE on the waters and M-SHAKE on the CH clusters,
   the reciprocal exclusion correction fused with the exception add-back)
   -> the initial U and F against a CPU float64 plain evaluation ->
   ``minimize`` (FIRE on K2, through the context cache) -> initial_state
   -> 1,000 steps in 500-step chunks: K2's launches exactly 1,001 of each,
   no bitfield overflow, the constraints to 1e-5, the final U and F against
   CPU float64; steps/s, ns/day, a profile with K2's device ms and the busy
   share, K2's bound on the path's own ring and on a fresh one against the
   plain version's, and K2's force kernel at the final state against its
   plain version, timed with its bound; (d) ``scripts.benchmark_dhfr`` at
   the JAC convention (200 steps, ``--no-check``: (c) holds that system)
   and with ``--reference-defaults`` (500 steps, its own check against CPU
   float64); (e) ``scripts.benchmark_remd`` cut to 16 replicas x 50 steps
   x 3 iterations on the vacuum stand-in: finite, the batched route; then
   a profile of 20 batched steps of that configuration (ATen calls a step,
   the constraints' host ms, the device's busy share);
19. every move tree as one batch of replicas: (a) replica exchange on
   14a's ladder and replicas, 'swap-all', with SequenceMove([a
   displacement and a rotation of the alchemical water, 14a's Langevin
   move]): the batched route, 3 iterations, K2's launches of each kernel
   an iteration by batch size (1 at B = 18 for each Monte Carlo move, 51
   at B = 9, 1 at B = 81: 54) beside the eager loop's (one iteration of
   the same tree, its Monte Carlo moves wrapped so that it cannot batch:
   478), seconds an
   iteration of each, the displacement and rotation acceptances; (b) 3
   replicas of the ladder, one application of 19a's tree batched and one
   ``apply`` a replica with the same generators: the accept decisions
   equal, the positions equal (the bits reported); (c) NPT parallel
   tempering on PMEWaterBox(6.223) at 15b's 4 temperatures and 1 bar with
   SequenceMove([LangevinDynamicsMove(50 steps), MonteCarloBarostatMove(5
   attempts)]), 3 iterations: K2 at B = 8 for each attempt, the replicas'
   boxes not all equal, the waters rigid to 1e-5, U at the final boxes
   against the plain sweep plus the remainder of each replica alone
   (2e-4); (d) per-state moves on the ladder (states 0-4 one Langevin
   move, 5-8 another timestep: two groups, launches by batch size) and a
   WeightedMove of the displacement and the rotation before a Langevin
   move (branch groups summing to 9); (e) the native prmtop parser on
   18a's JAC-size stand-in: its build, the parse seconds native and in
   pure Python, every section equal;
20. the API that closes the port: (a) 19c's 4 replicas through
   ``stack_sampler_states`` and as a list, each form through the batched
   energy route (``BoundIntegrator.energies_batch``): the same bits, one
   K2 launch of each kernel at B = 4 for each form, each
   ``index_sampler_state`` of the stack equal to its replica; (b) fault
   F10 on the card: 19c's NPT tree with its Langevin move replaced by
   ``IntegratorMove(LangevinIntegrator(...), 50 steps)`` (sweep mode, K2),
   built directly and rebuilt through ``move_to_dict`` ->
   ``move_from_dict`` (the integrators' ``serialize`` dicts equal), two
   samplers from one seed, 2 iterations each: positions, boxes and the
   energy matrix bit-equal, K2's launches by batch size equal (B = 4 and
   8), the two bound integrators' ``pretty_print`` equal.

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
WARMUP = 1_000           # phase 7; its temperature is read after the chunks
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
NCMC_STEPS = 250
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
    K2 (the sweep wrapper and its kernels; in sweep mode), the constraints
    (SETTLE and M-SHAKE) on positions and on velocities, the PME
    structure-factor einsums forward and backward, and the rest of the
    remainder (bonded terms, exception add-back, PME's other terms, forward
    and autograd backward). Returns the state, the profiled wall ms per
    step, the device's busy ms per step, per part (device ms, host ms) per
    step, the busiest kernels, and the ATen operator calls per step on the
    host (nested calls included).

    Each device activity goes to the innermost marked range that was open on
    the host when it was launched: the launch's runtime call, found by its
    correlation id, or else the operator it is linked to. "other" holds what
    falls in no range (the integrator's updates, the sort and its gathers)."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    import openmmtools_tpu_torch.integrators.langevin as lg
    from openmmtools_tpu_torch.ops import pme as tpme

    k2 = getattr(bound, "_sweep_kernel", None)   # None off sweep mode
    marks = {"K2 sweep": (k2, "evaluate"),
             "constraints, positions": (bound, "_constrain_positions"),
             "constraints, velocities": (bound, "_constrain_velocities"),
             "PME einsums, forward": (tpme, "_sf_forward_real"),
             "PME einsums, backward": (tpme, "_sf_real_backward"),
             "remainder, rest (fwd + bwd)": (lg, "value_and_grad")}
    marks = {label: (obj, name) for label, (obj, name) in marks.items()
             if obj is not None}
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
    ends = defaultdict(int)
    for lo, hi, name in sorted(ranges):
        if lo >= ends[name]:   # a recursive call is counted once
            host[name] += hi - lo
            ends[name] = hi
    per_step = 1e6 * n_steps
    parts = {label: (device[label] / per_step, host[label] / per_step)
             for label in list(marks) + ["other"]}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    aten = sum(e.name().startswith("aten::") for e in host_events) / n_steps
    say(f"{phase} profile: {len(work)} device activities, {linked} traced to "
        f"their launch; {aten:.0f} ATen operator calls a step on the host")
    return (state, 1e3 * wall / n_steps, busy_ns / per_step, parts,
            [(name, ns / per_step) for name, ns in top], aten)


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
        # the path's one replica: a batch of one sort set
        flags.append(torch.as_tensor(rebuild, device=xT.device).reshape(()))
        rings.append(xT.reshape(3, -1))
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
                                    "phase 7", temperature_last=True)
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

    state, wall_ms, busy_ms, parts, top, _ = profile_steps(bound, state, 50)
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

    state, wall_ms, busy_ms, parts, top, _ = profile_steps(
        bound, state, 50, phase="phase 9")
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
    move._on_integration_end = finals.append   # one batched state a run
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
    assert sampler.propagation_route == "batched"
    for key in k.launches:
        k.launches[key] = 0
    k.batch_launches.clear()
    t0 = time.perf_counter()
    sampler.run(MS_ITERATIONS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(k.launches)
    by_batch = dict(k.batch_launches)
    # the batched route: one launch of each kernel an evaluation for all
    # the replicas (the initial state's and one a step), and one for every
    # (replica, state) pair of the matrix
    per_iteration = (MS_STEPS + 1) + 1
    say(f"phase 14a {MS_ITERATIONS} iterations in {wall:.2f} s "
        f"({sampler.propagation_route} route); K2 launches {launches} "
        f"(expected {per_iteration} of each an iteration: {MS_STEPS + 1} "
        f"propagation evaluations of {n} replicas + 1 of the {n * n_states} "
        f"matrix pairs); by batch size {by_batch}")
    assert launches == {"sweep_bound": MS_ITERATIONS * per_iteration,
                        "sweep_forces_alch": MS_ITERATIONS * per_iteration}, \
        launches
    assert by_batch == {
        ("sweep_forces_alch", n): MS_ITERATIONS * (MS_STEPS + 1),
        ("sweep_forces_alch", n * n_states): MS_ITERATIONS,
        ("sweep_bound", n): MS_ITERATIONS * per_iteration}, by_batch
    u = sampler.energies_last_iteration
    s = sampler.replica_states
    assert u.shape == (n, n_states) and np.isfinite(u).all()
    worst = matrix_against_plain(bound, sampler, [(0, n_states - 1), (4, 2)])
    # u[n, s_n] against beta U of each replica's own final integrator state
    beta = sampler._stacked_states.beta.numpy()
    own = 0.0
    for r in range(n):
        u_run = beta[s[r]] * float(finals[-1].potentials[0][r])
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
    # the K2 device time of the eager loop's evaluations (one replica or
    # one pair a launch), which the batched launches of phase 17a replace
    evaluations = n * (MS_STEPS + 1) + n * n_states
    k2_lo = evaluations * (held["sweep_forces_alch"] + held["sweep_bound"])
    k2_hi = evaluations * (held["sweep_forces_alch"]
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
        f"of K2 device time an iteration in single launches ({evaluations} "
        f"evaluations; {smi})")
    return sampler, dict(
        atoms=system.n_particles, states=n_states, replicas=n,
        iterations=MS_ITERATIONS, steps_per_iteration=MS_STEPS,
        seconds_per_iteration=it_s, ns_per_day=ns_day, split_s=split,
        create_s=t_create, minimize_s=t_min, launches=launches,
        matrix_worst_rel=worst, own_state_worst_rel=own,
        swaps=[int(acc.sum()) // 2, int(prop.sum()) // 2],
        k2_held_ms=held, k2_ms_per_iteration=[k2_lo, k2_hi],
        storage_rel=analyzed, storage=("driven" if have_storage else why),
        batch_launches={f"{key} x{b}": c for (key, b), c in by_batch.items()})


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
    # the batch of one replica; the matrix's 9 pairs in one launch
    per_iteration = (MS_STEPS + 1) + 1
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
    move._on_integration_end = finals.append   # one batched state a run
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
        u_run = beta[s[r]] * float(finals[-1].potentials[0][r])
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
    attempt = MonteCarloBarostatMove.attempt_batch

    def timed_attempt(self, *args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = attempt(self, *args, **kwargs)
        accepted = int(out[1].sum())
        attempts.append((1e3 * (time.perf_counter() - t), accepted))
        return out

    def at_stage_end(i, stage, ss):
        torch.cuda.synchronize()
        ends.append(ss)

    start = w.sampler_state()
    MonteCarloBarostatMove.attempt_batch = timed_attempt
    try:
        t0 = time.perf_counter()
        out = run_gentle_equilibration(ts, start, stages, seed=15,
                                       context_cache=cache, timer=timer,
                                       callback=at_stage_end)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        MonteCarloBarostatMove.attempt_batch = attempt
    seconds = timer.report_timing()
    bounds = cache.bound_integrators()
    assert len(bounds) == 4, len(bounds)
    launches = [dict(b._sweep_kernel.launches) for b in bounds]
    applies = [barostat_applies(st) if st.stage_type == "npt" else 0
               for st in stages]
    expected = [EQ_MIN_ITERATIONS + 3] + [
        st.n_steps + 1 + a for st, a in zip(stages[1:], applies[1:])]
    say(f"phase 15a run_gentle_equilibration on PMEWaterBox({WATER_EDGE}) "
        f"({n} atoms, {n // 3} oxygens restrained at sigma {EQ_SIGMA} nm in "
        f"stages 1-3): {wall:.2f} s; K2 launches by stage {launches} "
        f"(expected {expected} of each: FIRE one an iteration + its final "
        f"energy + the acceptance check's two; dynamics n_steps + 1; one a "
        f"barostat attempt, its two configurations as one batch)")
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
    # (one batched launch of the two evaluations does the work of two)
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
    assert sampler.propagation_route == "batched"
    for k in kernels.values():
        for key in k.launches:
            k.launches[key] = 0
        k.batch_launches.clear()
    t0 = time.perf_counter()
    sampler.run(1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {key: sum(k.launches[key] for k in kernels.values())
                for key in ("sweep_bound", "sweep_forces")}
    by_batch = collections.Counter()
    for k in kernels.values():
        by_batch.update(k.batch_launches)
    # the batched route: one bound integrator (state 0's) evaluates the
    # replicas together, at each replica's own kT
    want = (PT_WATER_STEPS + 1) + 1
    say(f"phase 15b PT on PMEWaterBox({WATER_EDGE}), temperatures "
        f"{PT_WATER_TEMPERATURES} K, {n} replicas x {PT_WATER_STEPS} steps: "
        f"set-up (create, FIRE) {t_setup:.2f} s, one iteration {wall:.2f} s "
        f"({smi}); K2 launches {launches} (expected {want} of each: "
        f"{PT_WATER_STEPS + 1} propagation evaluations of the {n} replicas "
        f"+ 1 of their O(N) energies); by batch size {dict(by_batch)}")
    assert launches == {"sweep_bound": want, "sweep_forces": want}, launches
    assert dict(by_batch) == {("sweep_bound", n): want,
                              ("sweep_forces", n): want}, by_batch
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
                iteration_s=wall, launches=launches, worst_rel=worst,
                batch_launches={f"{key} x{b}": c
                                for (key, b), c in by_batch.items()},
                by_batch=by_batch)


# -- phase 16: the rest of the catalog, GBSA and neighbour mode ---------------

GB_STEPS = 1_000
# CustomGBForceSystem's +-1 ions carry a tiny LJ epsilon (0.0016 kJ/mol), so
# they collapse into contact pairs (about 0.12 nm) whose vibration, about
# 10 fs a period, leaves 2 fs at the edge of the Verlet limit: a float32
# BAOAB run at 2 fs went to NaN near step 650 (140 atoms) and 130 (2,048
# atoms) on the CPU, where 1 fs stayed finite through 1,000 and 200 steps
GB_TIMESTEP = 0.001
GB_SWEEP_MOLECULES = 1_024   # CustomGBForceSystem: 2,048 atoms
GB_SWEEP_STEPS = 200
NBR_N = 100_000              # neighbour mode's threshold on the card
NBR_T = 120.0
VSITE_EDGE = 3.3             # FourSiteWaterBox: 1,331 waters, 5,324 atoms
VSITE_STEPS = 500


def phase_catalog_sweep(dev, smi):
    """16a: the every-system parity sweep on the card over the catalog less
    ``_SLOW``: cuda/f32 and cpu/f32 against cpu/f64, and the kernel check
    wherever K1 or K2 engages; no failure, every name checked or skipped by
    name."""
    from openmmtools_tpu_torch.models import get_available_testsystems
    from openmmtools_tpu_torch.scripts import test_platforms as tp

    names = get_available_testsystems()
    t0 = time.perf_counter()
    results, failures, skipped = tp.run_sweep(
        names, failure_dir=str(ROOT / "build" / "platform-failures"),
        device="cuda")
    wall = time.perf_counter() - t0
    assert not failures, [(n, key) for n, key, _ in failures]
    checked = {row["system"] for row in results}
    named = {n for n, _ in skipped}
    assert checked == set(names) - tp._SLOW - named, checked
    by_path = collections.defaultdict(list)
    totals = collections.Counter()
    for row in results:
        by_path[row.get("kernel_path") or "none"].append(row["system"])
        totals.update(row.get("kernel_launches") or {})
        if row.get("kernel_path"):
            assert all(row["kernel_launches"].values()), row
    via = sorted(row["system"] for row in results
                 if row["checks"]["cuda/f32"]["via"] != "dense")
    say(f"phase 16a parity sweep: {len(results)} systems checked of "
        f"{len(names)} in the catalog, {wall:.2f} s; skipped by name "
        f"{skipped}; cuda/f32 through energy_forces_at (DENSE_LIMIT or "
        f"more atoms): {via or 'none'}")
    for path in ("K1", "K2", "K2-alchemical", "none"):
        say(f"phase 16a {path}: {sorted(by_path.get(path, []))}")
    worst = {key: max(row["checks"][key]["dU_kJ"] for row in results)
             for key in ("cpu/f32", "cuda/f32")}
    say(f"phase 16a kernel launches in the sweep's checks {dict(totals)}; "
        f"worst |dU| against cpu/f64 {worst} kJ/mol ({smi})")
    return dict(seconds=wall, checked=len(results), catalog=len(names),
                skipped=skipped, paths={k: sorted(v)
                                        for k, v in by_path.items()},
                launches=dict(totals), worst_dU_kJ=worst)


def _u_f_rel(u, f, u_ref, f_ref):
    """|dU| / |U_ref| and max |dF| / max |F_ref|, on the host in float64."""
    f, f_ref = f.detach().cpu().double(), f_ref.detach().cpu().double()
    return (abs(float(u) - float(u_ref)) / abs(float(u_ref)),
            float((f - f_ref).abs().max()) / float(f_ref.abs().max()))


def _cpu64_u_f(system, x, params=None):
    from openmmtools_tpu_torch.system import make_energy_fn, value_and_grad

    s64 = system.to(device="cpu", dtype=torch.float64)
    u_fn = make_energy_fn(s64)
    u, g = value_and_grad(lambda xx: u_fn(xx, s64.default_box, params),
                          x.detach().cpu().double())
    return u, -g


def phase_gbsa(dev, smi):
    """16b: CustomGBForceSystem() (140 atoms) on the generic program, 1,000
    BAOAB steps, the final U and F against CPU float64; the factory's
    alchemical version (the first molecule) at three lambdas. 16c: the
    2,048-atom version in sweep mode with the GB term in the remainder."""
    from openmmtools_tpu_torch.alchemy import (
        AbsoluteAlchemicalFactory,
        AlchemicalRegion,
    )
    from openmmtools_tpu_torch.integrators import BAOABIntegrator
    from openmmtools_tpu_torch.models import CustomGBForceSystem
    from openmmtools_tpu_torch.ops.gbsa import GBSAOBCTerm
    from openmmtools_tpu_torch.system import make_energy_fn, value_and_grad

    ts = CustomGBForceSystem(device=dev)
    bound = BAOABIntegrator(temperature=WATER_T, collision_rate=1.0,
                            timestep=GB_TIMESTEP).bind(ts.system)
    assert not (bound.sweep_mode or bound.neighbor_mode
                or bound._fused is not None)
    gen = torch.Generator(device=dev).manual_seed(16)
    state = bound.initial_state(ts.sampler_state(), gen)
    state = bound.run(state, 10)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = bound.run(state, GB_STEPS)
    torch.cuda.synchronize()
    ms_step = 1e3 * (time.perf_counter() - t0) / GB_STEPS
    x = state.positions
    assert torch.isfinite(x).all()
    u_ref, f_ref = _cpu64_u_f(ts.system, x)
    u_rel, f_rel = _u_f_rel(state.potentials[0], state.forces[0], u_ref,
                            f_ref)
    say(f"phase 16b CustomGBForceSystem ({ts.n_particles} atoms), generic "
        f"program, {GB_STEPS + 10} steps of {GB_TIMESTEP * 1e3:g} fs: "
        f"{ms_step:.3f} ms a step ({smi}); "
        f"final U {float(state.potentials[0]):.4f} vs CPU float64 "
        f"{float(u_ref):.4f} (rel {u_rel:.2e}), forces rel {f_rel:.2e}")
    assert u_rel <= REL_TOL and f_rel <= REL_TOL
    alch = AbsoluteAlchemicalFactory().create_alchemical_system(
        ts.system, AlchemicalRegion(alchemical_atoms=[0, 1]))
    gb = [t for t in alch.terms if isinstance(t, GBSAOBCTerm)]
    assert len(gb) == 1 and gb[0].alchemical is not None
    lam_rel = {}
    for lam in (0.0, 0.5, 1.0):
        params = {"lambda_electrostatics": lam, "lambda_sterics": 1.0}
        u = alch.energy(x, alch.default_box, {
            k: torch.tensor(v, device=dev) for k, v in params.items()})
        s64 = alch.to(device="cpu", dtype=torch.float64)
        u64 = s64.energy(x.cpu().double(), s64.default_box, {
            k: torch.tensor(v, dtype=torch.float64)
            for k, v in params.items()})
        lam_rel[lam] = abs(float(u) - float(u64)) / abs(float(u64))
        say(f"phase 16b alchemical GB (the first molecule) at "
            f"lambda_electrostatics {lam}: U {float(u):.4f} vs CPU float64 "
            f"{float(u64):.4f} (rel {lam_rel[lam]:.2e})")
        assert lam_rel[lam] <= REL_TOL

    big = CustomGBForceSystem(n_molecules=GB_SWEEP_MOLECULES, device=dev)
    b2 = BAOABIntegrator(temperature=WATER_T, collision_rate=1.0,
                         timestep=GB_TIMESTEP).bind(big.system)
    assert b2.sweep_mode and b2._sweep_alch is None
    assert GBSAOBCTerm in [type(t) for t in b2._sweep_leftover]
    k = b2._sweep_kernel
    s2 = b2.initial_state(big.sampler_state(),
                          torch.Generator(device=dev).manual_seed(17))
    u_fn = make_energy_fn(big.system)
    u_d, g_d = value_and_grad(
        lambda xx: u_fn(xx, big.system.default_box), big.positions)
    u2_rel, f2_rel = _u_f_rel(s2.potentials[0], s2.forces[0], u_d, -g_d)
    say(f"phase 16c CustomGBForceSystem(n_molecules={GB_SWEEP_MOLECULES}) "
        f"({big.n_particles} atoms) in sweep mode, GB in the remainder: "
        f"initial U {float(s2.potentials[0]):.4f} vs dense cuda/f32 "
        f"{float(u_d):.4f} (rel {u2_rel:.2e}), forces rel {f2_rel:.2e}")
    assert u2_rel <= REL_TOL and f2_rel <= REL_TOL
    for key in k.launches:
        k.launches[key] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s2 = b2.run(s2, GB_SWEEP_STEPS)
    torch.cuda.synchronize()
    ms2 = 1e3 * (time.perf_counter() - t0) / GB_SWEEP_STEPS
    launches = dict(k.launches)
    assert torch.isfinite(s2.positions).all()
    assert launches == {"sweep_bound": GB_SWEEP_STEPS,
                        "sweep_forces": GB_SWEEP_STEPS}, launches
    say(f"phase 16c {GB_SWEEP_STEPS} steps of {GB_TIMESTEP * 1e3:g} fs: "
        f"{ms2:.3f} ms a step ({smi}); "
        f"K2 launches {launches}")
    return dict(gb_ms_step=ms_step, gb_final_rel=[u_rel, f_rel],
                gb_alchemical_rel=lam_rel, gb_sweep_initial_rel=[u2_rel,
                                                                 f2_rel],
                gb_sweep_ms_step=ms2, gb_sweep_launches=launches)


def phase_neighbor_mode(dev, smi):
    """16d: neighbour mode at its threshold on the card:
    LennardJonesFluid(100,000) on a lattice at the catalog's density,
    BAOAB with sweep off; two rebuild intervals, of which the first takes
    initial_state's list; the final U against a float64 recomputation over
    a fresh blocked list and against K2, and the same steps timed on K2,
    the path this fluid takes by default on the card."""
    from openmmtools_tpu_torch.constants import kB
    from openmmtools_tpu_torch.integrators import BAOABIntegrator
    from openmmtools_tpu_torch.models import LennardJonesFluid
    from openmmtools_tpu_torch.ops.neighborlist import build_neighbor_list
    from openmmtools_tpu_torch.states import SamplerState

    fluid = LennardJonesFluid(nparticles=NBR_N, lattice=True, device=dev)
    term = fluid.system.terms[0]
    integ = BAOABIntegrator(temperature=NBR_T, collision_rate=1.0,
                            timestep=0.002, sweep=None)
    bound = integ.bind(fluid.system)
    assert bound.neighbor_mode and bound._fused is None
    assert not bound.sweep_mode
    r_list = 1.35 * term.cutoff
    avg = NBR_N / fluid.box_edge ** 3 * 4.0 / 3.0 * math.pi * r_list ** 3
    v_th = math.sqrt(kB * NBR_T / float(fluid.system.masses[0]))
    interval = min(200, int(0.5 * 0.35 * term.cutoff
                            / (4.0 * v_th * 0.002)))
    assert abs(bound.neighbor_r_list - r_list) <= 1e-12 * r_list
    assert abs(bound.neighbor_k_max - math.ceil(2.5 * avg + 8)) <= 1
    assert bound.neighbor_rebuild_interval == interval
    gen = torch.Generator(device=dev).manual_seed(18)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = bound.initial_state(fluid.sampler_state(), gen,
                                temperature=NBR_T)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    x0, v0, box = state.positions, state.velocities, fluid.system.default_box
    rebuild = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bound._build_nbr(x0, box)
        torch.cuda.synchronize()
        rebuild.append(1e3 * (time.perf_counter() - t0))
    builds = []
    build = bound._build_nbr

    def counted(xx, bb):
        builds.append(1)
        return build(xx, bb)

    bound._build_nbr = counted
    steps = 2 * interval
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = bound.run(state, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms_rebuild = statistics.median(rebuild)
    ms_step = (1e3 * wall - len(builds) * ms_rebuild) / steps
    # initial_state's list serves the first interval: one build in the run
    assert len(builds) == 1, builds
    assert not bool(state.nbr_overflow)
    assert torch.isfinite(state.positions).all()
    x = state.positions
    term64 = term.to(dtype=torch.float64)
    x64, box64 = x.double(), box.double()
    fresh = build_neighbor_list(x64, box64, bound.neighbor_r_list,
                                bound.neighbor_k_max)
    assert not bool(fresh.overflow)
    u64 = float(term64.energy_neighbors(x64, box64, None, fresh))
    u_run = float(state.potentials[0])
    rel64 = abs(u_run - u64) / abs(u64)
    # the default bind: sweep mode replaces the list at this size
    k2 = BAOABIntegrator(temperature=NBR_T, collision_rate=1.0,
                         timestep=0.002).bind(fluid.system)
    assert k2.sweep_mode and not k2.neighbor_mode
    u_k2 = float(k2.energies_at(x, box, [{}])[0])
    rel_k2 = abs(u_run - u_k2) / abs(u_k2)
    # the same steps from the same start on K2
    s_k2 = k2.initial_state(SamplerState(positions=x0, velocities=v0,
                                         box_vectors=box),
                            torch.Generator(device=dev).manual_seed(18),
                            temperature=NBR_T)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_k2 = k2.run(s_k2, steps)
    torch.cuda.synchronize()
    k2_ms_step = 1e3 * (time.perf_counter() - t0) / steps
    assert torch.isfinite(s_k2.positions).all()
    say(f"phase 16d neighbour mode, LennardJonesFluid({NBR_N}) on a "
        f"lattice, {NBR_T} K: k_max {bound.neighbor_k_max}, r_list "
        f"{bound.neighbor_r_list:.4f} nm, rebuild every "
        f"{bound.neighbor_rebuild_interval} steps; initial state "
        f"{t_init:.2f} s; {steps} steps in {wall:.2f} s with "
        f"{len(builds)} rebuild: {ms_rebuild:.2f} ms a rebuild, "
        f"{ms_step:.3f} ms a step; the same {steps} steps on K2 (the "
        f"default path): {k2_ms_step:.3f} ms a step, re-sorts included "
        f"({smi})")
    say(f"phase 16d final U {u_run:.4f} vs float64 over a fresh blocked list "
        f"{u64:.4f} (rel {rel64:.2e}) and K2 {u_k2:.4f} (rel {rel_k2:.2e}); "
        f"overflow {bool(state.nbr_overflow)}")
    assert rel64 <= REL_TOL and rel_k2 <= REL_TOL
    return dict(k_max=bound.neighbor_k_max, r_list=bound.neighbor_r_list,
                interval=bound.neighbor_rebuild_interval, steps=steps,
                init_s=t_init, ms_rebuild=ms_rebuild, ms_step=ms_step,
                k2_ms_step=k2_ms_step, rel_f64=rel64, rel_k2=rel_k2)


def phase_virtual_sites(dev, smi):
    """16f: FourSiteWaterBox(3.3) (5,324 atoms, DENSE_LIMIT or more) bound
    by default on the card: sweep mode with the M-sites rebuilt from their
    parents before each sort and evaluation; 500 steps of 2 fs, K2 at every
    step, the final U and F against the CPU float64 dense sum."""
    from openmmtools_tpu_torch.integrators import BAOABIntegrator
    from openmmtools_tpu_torch.models import FourSiteWaterBox
    from openmmtools_tpu_torch.system import DENSE_LIMIT

    ts = FourSiteWaterBox(box_edge=VSITE_EDGE, device=dev)
    n = ts.system.n_particles
    vs = ts.system.virtual_sites
    assert n >= DENSE_LIMIT and vs.n_sites > 0
    bound = BAOABIntegrator(temperature=WATER_T, collision_rate=1.0,
                            timestep=0.002).bind(ts.system)
    assert bound.sweep_mode and bound._vsites is not None
    assert not bound.neighbor_mode
    k = bound._sweep_kernel
    state = bound.initial_state(ts.sampler_state(),
                                torch.Generator(device=dev).manual_seed(19))
    sites0 = vs.reconstruct(state.positions)[vs.site.long()]
    for key in k.launches:
        k.launches[key] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = bound.run(state, VSITE_STEPS)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / VSITE_STEPS
    launches = dict(k.launches)
    assert launches == {"sweep_bound": VSITE_STEPS,
                        "sweep_forces": VSITE_STEPS}, launches
    assert torch.isfinite(state.positions).all()
    # how far the sites moved with their parents: the stale places the
    # kernel would have read without the rebuild
    moved = float((vs.reconstruct(state.positions)[vs.site.long()]
                   - sites0).norm(dim=-1).max())
    u_ref, f_ref = _cpu64_u_f(ts.system, state.positions)
    u_rel, f_rel = _u_f_rel(state.potentials[0], state.forces[0], u_ref,
                            f_ref)
    say(f"phase 16f FourSiteWaterBox({VSITE_EDGE}) ({n} atoms, "
        f"{vs.n_sites} M-sites), default bind: sweep mode; {VSITE_STEPS} "
        f"steps of 2 fs: {ms:.3f} ms a step ({smi}); K2 launches "
        f"{launches}; the sites moved up to {moved:.3f} nm; final U "
        f"{float(state.potentials[0]):.4f} vs CPU float64 dense "
        f"{float(u_ref):.4f} (rel {u_rel:.2e}), forces rel {f_rel:.2e}")
    assert u_rel <= REL_TOL and f_rel <= REL_TOL
    return dict(atoms=n, steps=VSITE_STEPS, ms_step=ms, launches=launches,
                site_moved_nm=moved, final_rel=[u_rel, f_rel])


def phase_benchmark_alchemy(smi):
    """16e: scripts.benchmark_alchemy at its defaults (512 particles, 100
    iterations) on the card."""
    import contextlib
    import io
    import re

    from openmmtools_tpu_torch.scripts import benchmark_alchemy

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = benchmark_alchemy.main([])
    assert rc == 0
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        say(f"phase 16e benchmark_alchemy: {line} ({smi})")
    us = {m.group(1): float(m.group(2)) for m in (
        re.match(r"(\w+)\s+energy\+force: ([0-9.]+) us/eval", line)
        for line in lines) if m}
    assert set(us) == {"reference", "alchemical"}, lines
    return us


def phase_catalog(dev, smi):
    t0 = time.perf_counter()
    out = {"sweep": phase_catalog_sweep(dev, smi)}
    out.update(phase_gbsa(dev, smi))
    out["neighbor_mode"] = phase_neighbor_mode(dev, smi)
    out["benchmark_alchemy_us"] = phase_benchmark_alchemy(smi)
    out["virtual_sites"] = phase_virtual_sites(dev, smi)
    out["seconds"] = time.perf_counter() - t0
    say(f"phase 16 in {out['seconds']:.1f} s")
    return out


# -- phase 17: replicas as one batched axis, the demo, atom sharding ---------

BATCH_STEPS = 50          # 17c: steps of the batched-against-eager check
BATCH_REPLICAS = 3
EAGER_STEPS = 10          # 17b: the eager loop's short run
SHARD_EDGE = 3.6          # 17e: PMEWaterBox(3.6), 5,184 atoms
SHARD_BLOCKS = 4
# 17d: demo_free_energy at a cut depth (the JAX script's: 600 x 200 REMD
# steps, 2 x 256 protocols of 4,000 + 6,000 NCMC steps, 400 x 100 Widom
# steps); every route keeps its 4,000 equilibration steps from the start's
# clashes
DEMO_CUT = ["--n-iter", "60", "--steps-per-iter", "50",
            "--n-protocols", "32", "--n-steps-eq", "4000",
            "--n-steps-neq", "500", "--n-snapshots", "64",
            "--steps-between", "50", "--n-insertions", "64",
            "--n-eq-widom", "4000"]


def once_ms(fn):
    """Wall ms of one synchronized call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), out


def sort_sets(term, x, box, k, params_of):
    """The kernels' batched inputs of configurations ``x`` (R, N, 3) at
    boxes (R, 3, 3): the R sort sets (xT, excl, L) and each evaluation's
    (par, lam) at the parameter dicts ``params_of`` (one an evaluation;
    ``rep`` maps them to their sets)."""
    from openmmtools_tpu_torch.ops import sweep_nb as tsw

    perm, inv = tsw.sort_for_sweep(x, box, k.n_pad)
    _, xT = tsw.sorted_positions(x, box, perm.long(), k.n_pad, torch.float32)
    sigma, sqrt_eps, charge, code = tsw.term_params(term)
    par = tsw.sorted_params(sigma, sqrt_eps, charge, perm.long(), k.n_pad,
                            torch.float32, code)
    excl, max_sep = tsw.build_exclusion_bitfield(term.exception_index, inv,
                                                 k.n_pad, k.mask_rows)
    assert int(max_sep.max()) <= k.mask_shells
    L = torch.diagonal(box, dim1=-2, dim2=-1).to(torch.float32).contiguous()
    lam = None
    if k.alchemical:
        lam = torch.stack([term.sweep_lambdas(p, xT)[0] for p in params_of])
    return xT.contiguous(), par, excl, L, lam


def batch_bound_ms(xT, L, k, nb, rep, alchemical):
    """The least time of one batched force launch (ms, by): each
    evaluation's pairs once (its set's window at its bound), the sets'
    inputs read once, each evaluation's parameters, class scalars and
    outputs once."""
    rep = rep.tolist()
    counts = {}
    for r in set(rep):
        S = min(int(nb[r]) * k.bs, k.n_pad // 2)
        counts[r] = sweep_pairs(xT[r], L[r], k, S)
    tested = sum(counts[r][0] for r in rep)
    inside = sum(counts[r][1] for r in rep)
    R, B = xT.shape[0], len(rep)
    n_par = 4 if alchemical else 3
    n_bytes = (R * 4 * (3 * k.n_pad + k.mask_rows * k.n_pad + 3 + 1)
               + B * 4 * (n_par * k.n_pad + (k.n_lam if alchemical else 0)
                          + 3 * k.n_pad + 1 + 1))
    ops = tested * OPS_DIST + inside * (OPS_PAIR_ALCH if alchemical
                                        else OPS_PAIR)
    return bound_ms(n_bytes, ops), tested, inside


def check_batch(k, plain, xT, par, excl, L, lam, rep, label):
    """One batched launch of each kernel against its plain version, a
    second launch and single launches: (nb, F, U, worst abs and relative
    error, plain ms)."""
    R = xT.shape[0]
    dev = xT.device
    flags = torch.ones((R,), dtype=torch.bool, device=dev)
    zero = torch.zeros((R,), dtype=torch.int32, device=dev)
    nb = k.measure_bound(xT, L, flags, zero)
    nb2 = k.measure_bound(xT, L, flags, zero)
    singles = torch.cat([k.measure_bound(xT[r], L[r], flags[r], zero[r])
                         for r in range(R)])
    nb_ref = plain.measure_bound(xT, L, flags, zero)
    assert torch.equal(nb, nb2) and torch.equal(nb, singles), label
    assert torch.equal(nb.cpu(), nb_ref.cpu()), (label, nb, nb_ref)
    rep_k = None if rep is None else rep.to(torch.int32)
    F, U = k.sweep(xT, par, excl, L, nb, lam, rep_k)
    F2, U2 = k.sweep(xT, par, excl, L, nb, lam, rep_k)
    assert torch.equal(F, F2) and torch.equal(U, U2), label
    sets = range(par.shape[0]) if rep is None else rep.tolist()
    for b, r in enumerate(sets):
        F1, U1 = k.sweep(xT[r], par[b], excl[r], L[r], nb[r:r + 1],
                         None if lam is None else lam[b])
        assert torch.equal(F[b], F1) and torch.equal(U[b:b + 1], U1), \
            (label, b)
    p_ms, (F_ref, U_ref) = once_ms(
        lambda: plain.sweep(xT, par, excl, L, nb, lam, rep_k))
    f_err = float((F - F_ref).abs().max())
    f_rel = f_err / float(F_ref.abs().max())
    u_rel = float(((U.double() - U_ref.double()).abs()
                   / U_ref.double().abs()).max())
    assert f_rel <= REL_TOL and u_rel <= REL_TOL, (label, f_rel, u_rel)
    return nb, F, U, (f_err, f_rel, u_rel), p_ms


def phase_batched_kernels(dev, smi, re_sampler, launches14, launches15):
    """17a: K2 with a replica axis at the main paths' shapes: the
    alchemical ladder's 9 replicas as the propagation's batch (B = R = 9)
    and the matrix's 81 (replica, state) pairs (B = 81 on R = 9), and the
    standard variant on 4 configurations of PMEWaterBox(6.223): each
    launch twice for the same bits, against single launches for the same
    bits and against the plain version; the batched launches' device times
    beside a single launch's and the bounds of B evaluations."""
    from openmmtools_tpu_torch.models import PMEWaterBox
    from openmmtools_tpu_torch.ops import sweep_nb as tsw

    bound = re_sampler._matrix_bound()
    k = bound._sweep_kernel
    plain = tsw.PlainSweepNonbonded.like(k)
    term = bound._sweep_alch
    sss = re_sampler.sampler_states
    s = re_sampler.replica_states
    R = len(sss)
    params = re_sampler._params_on(sss[0].positions.device,
                                   sss[0].positions.dtype)
    x = torch.stack([ss.positions for ss in sss])
    box = torch.stack([ss.box_vectors for ss in sss])
    before = dict(k.launches)
    entries, out = [], {}
    cases = [("propagation", None, [params[int(s[r])] for r in range(R)]),
             ("energy matrix",
              torch.arange(R, device=dev).repeat_interleave(R),
              [params[c] for _ in range(R) for c in range(R)])]
    for label, rep, params_of in cases:
        xT, par, excl, L, lam = sort_sets(term, x, box, k, params_of)
        if rep is not None:
            par = par[rep].contiguous()
        B = par.shape[0]
        nb, F, U, errs, p_ms = check_batch(k, plain, xT, par, excl, L, lam,
                                           rep, label)
        rep_k = None if rep is None else rep.to(torch.int32)
        ms = launch_ms(lambda: k.sweep(xT, par, excl, L, nb, lam, rep_k),
                       "sweep_forces_alch_f32", reps=20)
        one_ms = launch_ms(lambda: k.sweep(xT[0], par[0], excl[0], L[0],
                                           nb[0:1], lam[0]),
                           "sweep_forces_alch_f32", reps=20)
        (b_ms, b_by), tested, inside = batch_bound_ms(
            xT, L, k, nb, torch.arange(R) if rep is None else rep.cpu(),
            True)
        say(f"phase 17a sweep_forces_alch, {label}: B = {B} evaluations on "
            f"R = {R} sort sets, one launch {ms:.4f} ms device (one "
            f"evaluation alone {one_ms:.4f} ms, x{B} = {B * one_ms:.3f}); "
            f"twice and against {B} single launches: the same bits; against "
            f"the plain version max|dF| {errs[0]:.3e} (rel {errs[1]:.2e}), "
            f"U rel {errs[2]:.2e}, plain {p_ms:.1f} ms; bound {b_ms:.4f} ms "
            f"by {b_by} ({tested:.0f} pair tests, {inside:.0f} inside) "
            f"({smi})")
        entries.append(dict(
            name=f"sweep_forces_alch (batch of {B}, {label})", route="cuda",
            source=SWEEP_SOURCE, replaces=SWEEP_REPLACES,
            launches=launches14[("sweep_forces_alch", B)],
            max_abs_err=errs[0], ms=ms, plain_ms=p_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None))
        out[label] = dict(B=B, ms=ms, one_ms=one_ms, plain_ms=p_ms,
                          bound_ms=b_ms, f_rel=errs[1], u_rel=errs[2])
    # the bound kernel over the 9 sets, on a rebuild of each
    flags = torch.ones((R,), dtype=torch.bool, device=dev)
    zero = torch.zeros((R,), dtype=torch.int32, device=dev)
    nb = k.measure_bound(xT, L, flags, zero)
    b_ms = launch_ms(lambda: k.measure_bound(xT, L, flags, zero),
                     "sweep_bound_f32", reps=20)
    p_ms, _ = once_ms(lambda: plain.measure_bound(xT, L, flags, zero))
    floor = sum(bound_floor_tests(xT[r], L[r], k, int(nb[r]))
                for r in range(R))
    bb = bound_ms(4 * R * (3 * k.n_pad + 3 + 2 + 1), floor * OPS_DIST)
    say(f"phase 17a sweep_bound on a rebuild of {R} sort sets: one launch "
        f"{b_ms:.5f} ms device, plain {p_ms:.1f} ms, bound {bb[0]:.6f} ms "
        f"by {bb[1]} ({floor} tile tests no scan can skip) ({smi})")
    entries.append(dict(
        name=f"sweep_bound (batch of {R} sort sets, rebuild)", route="cuda",
        source=SWEEP_SOURCE, replaces=SWEEP_REPLACES,
        launches=launches14[("sweep_bound", R)], max_abs_err=0.0, ms=b_ms,
        plain_ms=p_ms, bound_ms=bb[0], bound_by=bb[1], library_ms=None))
    out["bound"] = dict(R=R, ms=b_ms, plain_ms=p_ms, bound_ms=bb[0])
    k.launches.update(before)   # the comparisons' launches are not the path's

    # the standard variant: PMEWaterBox(6.223), 4 configurations
    w = PMEWaterBox(box_edge=WATER_EDGE, device=dev)
    bw = w.system
    from openmmtools_tpu_torch.integrators import BAOABIntegrator

    kw = BAOABIntegrator(temperature=WATER_T).bind(bw)._sweep_kernel
    plain_w = tsw.PlainSweepNonbonded.like(kw)
    g = torch.Generator(device=dev).manual_seed(170)
    xw = torch.stack([w.positions + 2e-3 * torch.randn(
        w.positions.shape, generator=g, device=dev) for _ in range(4)])
    boxw = bw.default_box.expand(4, 3, 3)
    xT, par, excl, L, _ = sort_sets(bw.terms[0], xw, boxw, kw, [{}] * 4)
    nbw, F, U, errs, p_ms = check_batch(kw, plain_w, xT, par, excl, L, None,
                                        None, "standard")
    ms = launch_ms(lambda: kw.sweep(xT, par, excl, L, nbw),
                   "sweep_forces_f32", reps=20)
    one_ms = launch_ms(lambda: kw.sweep(xT[0], par[0], excl[0], L[0],
                                        nbw[0:1]), "sweep_forces_f32", reps=20)
    (b_ms, b_by), tested, inside = batch_bound_ms(xT, L, kw, nbw,
                                                  torch.arange(4), False)
    say(f"phase 17a sweep_forces, PMEWaterBox({WATER_EDGE}) x 4: one launch "
        f"{ms:.4f} ms device (one evaluation alone {one_ms:.4f} ms); the "
        f"same bits twice and against 4 single launches; against the plain "
        f"version max|dF| {errs[0]:.3e} (rel {errs[1]:.2e}), U rel "
        f"{errs[2]:.2e}, plain {p_ms:.1f} ms; bound {b_ms:.4f} ms by {b_by} "
        f"({smi})")
    entries.append(dict(
        name="sweep_forces (batch of 4, PT on the water box)", route="cuda",
        source=SWEEP_SOURCE, replaces=SWEEP_REPLACES,
        launches=launches15[("sweep_forces", 4)], max_abs_err=errs[0],
        ms=ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None))
    out["standard"] = dict(B=4, ms=ms, one_ms=one_ms, plain_ms=p_ms,
                           bound_ms=b_ms, f_rel=errs[1], u_rel=errs[2])
    return entries, out


def apply_only(move):
    """``move`` wrapped in a move that implements only ``_apply``, as a
    user's move may: a tree that holds it cannot batch, so the sampler
    takes its eager loop; the draws are ``move``'s own."""
    from openmmtools_tpu_torch.mcmc import MCMCMove

    class ApplyOnly(MCMCMove):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def _apply(self, ts, ss, generator, context_cache):
            return self.inner.apply(ts, ss, generator=generator,
                                    context_cache=context_cache)

    return ApplyOnly(move)


def phase_eager_loop(dev, smi, re_sampler):
    """17b: the eager loop on the ladder, driven by a tree that cannot
    batch (a SequenceMove of the Langevin move and a displacement wrapped
    in a move that implements only ``_apply``): one iteration, each
    replica its own apply. The same SequenceMove unwrapped takes the
    batched route (phase 19)."""
    from openmmtools_tpu_torch.mcmc import (
        LangevinSplittingDynamicsMove,
        MCDisplacementMove,
        SequenceMove,
    )
    from openmmtools_tpu_torch.multistate import ReplicaExchangeSampler

    states = re_sampler._thermodynamic_states
    langevin = LangevinSplittingDynamicsMove(
        timestep=0.002, collision_rate=1.0, n_steps=EAGER_STEPS,
        splitting="V R O R V")
    displacement = MCDisplacementMove(atom_subset=[0, 1, 2])
    k = langevin._bound(states[0])._sweep_kernel
    unwrapped = ReplicaExchangeSampler(
        mcmc_moves=SequenceMove([langevin, displacement]),
        number_of_iterations=1, online_analysis_interval=None)
    unwrapped._thermodynamic_states = states
    assert unwrapped.propagation_route == "batched"
    sampler = ReplicaExchangeSampler(
        mcmc_moves=SequenceMove([langevin, apply_only(displacement)]),
        number_of_iterations=1, online_analysis_interval=None, rng_seed=171)
    sampler.create(states, re_sampler.sampler_states)
    assert sampler.propagation_route == "eager"
    k.batch_launches.clear()
    t0 = time.perf_counter()
    sampler.run(1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = sampler.n_replicas
    by_batch = dict(k.batch_launches)
    u = sampler.energies_last_iteration
    assert np.isfinite(u).all()
    assert by_batch.get(("sweep_forces_alch", 1), 0) >= n * (EAGER_STEPS + 1)
    say(f"phase 17b the eager loop ({sampler.propagation_route} route: a "
        f"SequenceMove of the Langevin move, {EAGER_STEPS} steps, and a "
        f"displacement of the first water in a move that implements only "
        f"_apply) on the ladder's {n} replicas: one iteration in "
        f"{wall:.2f} s ({smi}); K2 launches by batch size {by_batch}")
    return dict(route=sampler.propagation_route, iteration_s=wall,
                batch_launches={f"{key} x{b}": c
                                for (key, b), c in by_batch.items()})


def phase_batched_against_eager(dev, smi, re_sampler):
    """17c: 3 replicas of the ladder, 50 steps, through the batched program
    and one by one with the same generators: the final U and forces."""
    move = water_move()
    states = re_sampler._thermodynamic_states
    bound = move._bound(states[0])
    idx = [0, 4, 8]
    sss = [re_sampler.sampler_states[i] for i in idx]
    ts = [states[int(re_sampler.replica_states[i])] for i in idx]

    def gens():
        return [torch.Generator(device=dev).manual_seed(172 + i)
                for i in range(BATCH_REPLICAS)]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = bound.initial_state_batch(sss, gens(), thermodynamic_states=ts)
    batch = bound.run(batch, BATCH_STEPS)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    t0 = time.perf_counter()
    eager = [bound.run(bound.initial_state(ss, g, thermodynamic_state=st),
                       BATCH_STEPS) for ss, g, st in zip(sss, gens(), ts)]
    torch.cuda.synchronize()
    t_eager = time.perf_counter() - t0
    u_rel = f_rel = 0.0
    for b, st in enumerate(eager):
        u_rel = max(u_rel, abs(float(batch.potentials[0][b])
                               - float(st.potentials[0]))
                    / abs(float(st.potentials[0])))
        f_rel = max(f_rel, max_rel(batch.forces[0][b], st.forces[0]))
    say(f"phase 17c {BATCH_REPLICAS} replicas of the ladder x {BATCH_STEPS} "
        f"steps: batched {t_batch:.2f} s, eager {t_eager:.2f} s; final U "
        f"worst rel {u_rel:.2e}, F worst rel {f_rel:.2e} of scale ({smi})")
    assert u_rel <= REL_TOL and f_rel <= REL_TOL, (u_rel, f_rel)
    return dict(batched_s=t_batch, eager_s=t_eager, u_rel=u_rel,
                f_rel=f_rel)


def phase_demo(smi):
    """17d: scripts.demo_free_energy at the cut depth DEMO_CUT on the card:
    exit 0 (the three routes within 6 sigma) and its summary."""
    import contextlib
    import io

    from openmmtools_tpu_torch.scripts import demo_free_energy

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = demo_free_energy.main(DEMO_CUT)
    wall = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    for line in lines[:-1]:
        say(f"phase 17d demo_free_energy: {line}")
    summary = json.loads(lines[-1])
    say(f"phase 17d demo_free_energy at {' '.join(DEMO_CUT)}: exit {rc} in "
        f"{wall:.1f} s; seconds a route {summary['seconds']} ({smi})")
    assert rc == 0, summary
    return dict(summary, wall_s=wall)


def phase_atom_shard(dev, smi):
    """17e: parallel.atom_shard on PMEWaterBox(3.6) over a 4-block mesh on
    the one card, against the bound integrator's energy_forces_at."""
    from openmmtools_tpu_torch.integrators import BAOABIntegrator
    from openmmtools_tpu_torch.models import PMEWaterBox
    from openmmtools_tpu_torch.parallel import replica_mesh
    from openmmtools_tpu_torch.parallel.atom_shard import (
        make_sharded_energy_force_fn,
    )

    w = PMEWaterBox(box_edge=SHARD_EDGE, device=dev)
    system = w.system
    mesh = replica_mesh(devices=[dev] * SHARD_BLOCKS, axis_name="atom")
    fn = make_sharded_energy_force_fn(system, mesh)
    x, box = w.positions, system.default_box
    ms, (u, f) = once_ms(lambda: fn(x, box, {}))
    ms, (u, f) = once_ms(lambda: fn(x, box, {}))
    bound = BAOABIntegrator(temperature=WATER_T).bind(system)
    assert bound.sweep_mode
    u_ref, f_ref = bound.energy_forces_at(x, box, {})
    u_rel = abs(float(u) - float(u_ref)) / abs(float(u_ref))
    f_rel = max_rel(f.to(f_ref.dtype), f_ref)
    say(f"phase 17e atom_shard on PMEWaterBox({SHARD_EDGE}) "
        f"({system.n_particles} atoms) over {SHARD_BLOCKS} blocks of "
        f"{-(-system.n_particles // SHARD_BLOCKS)} rows: {ms:.1f} ms an "
        f"evaluation; U {float(u):.3f} vs the sweep path {float(u_ref):.3f} "
        f"(rel {u_rel:.2e}), F rel {f_rel:.2e} ({smi})")
    assert u_rel <= REL_TOL and f_rel <= REL_TOL, (u_rel, f_rel)
    return dict(atoms=system.n_particles, blocks=SHARD_BLOCKS, ms=ms,
                u_rel=u_rel, f_rel=f_rel)



# ---------------------------------------------------------------------------
# phase 18: the Amber loader and the prmtop systems. The prmtop writer and
# the stand-ins' constructors below are test data (the CPU tests import them):
# they write the documented Amber formats that models/amber.py reads.
# ---------------------------------------------------------------------------

KCAL_KJ = 4.184
AMBER_CHARGE = 18.2223
PRMTOP_FORMATS = {"a": ("20a4", 20, 4), "i": ("10I8", 10, 8),
                  "e": ("5E16.8", 5, 16)}
# GAFF c3/hc and TIP3P: per type (name, R* Å, eps kcal/mol, mass, atomic
# number, GB radius Å, GB screen)
GAFF_TYPES = {
    "c3": ("c3", 1.908, 0.1094, 12.01, 6, 1.7, 0.72),
    "hc": ("hc", 1.487, 0.0157, 1.008, 1, 1.3, 0.85),
}
TIP3P_OW = ("OW", 0.31507, 0.635968, 15.99943, 8, 1.5, 0.85)   # sigma nm, kJ
TIP3P_HW = ("HW", None, 0.0, 1.007947, 1, 0.8, 0.85)
TIP3P_Q = (-0.834, 0.417)
TIP3P_ROH = 0.9572                       # Å
TIP3P_HOH = math.radians(104.52)
# bonds (K kcal/mol/Å^2, r0 Å), angles (K kcal/mol/rad^2, theta0 deg),
# torsions (K kcal/mol, n, phase deg)
GAFF_BONDS = {"c3-c3": (303.1, 1.535), "c3-hc": (337.3, 1.092),
              "OW-HW": (553.0, TIP3P_ROH),
              "HW-HW": (553.0, 2.0 * TIP3P_ROH * math.sin(TIP3P_HOH / 2))}
GAFF_ANGLES = {"c3-c3-c3": (63.21, 110.63), "c3-c3-hc": (46.37, 110.05),
               "hc-c3-hc": (39.43, 108.35)}
GAFF_CCCC = ((0.18, 3, 0.0), (0.25, 2, 180.0), (0.20, 1, 180.0))
GAFF_XCCX = (0.156, 3, 0.0)
IMPROPER = (0.1, 2, 180.0)       # one a chain, on its second carbon
SCEE, SCNB = 1.2, 2.0


class Topology:
    """A molecular topology in Amber's terms, as lists: atoms (name,
    residue, type, charge e), residues (label, first atom), bonds (i, j,
    type name), angles (i, j, k, type name), torsions (i, j, k, l, (K, n,
    phase deg), improper), and the LJ/mass/GB data of each atom type; the
    positions in nm and the box edge in nm (None: not periodic)."""

    def __init__(self):
        self.names, self.residue_of, self.types, self.charges = [], [], [], []
        self.residues = []
        self.bonds, self.angles, self.torsions = [], [], []
        self.type_data = {}
        self.positions = []
        self.box = None

    def add_residue(self, label):
        self.residues.append((label, len(self.names)))

    def add_atom(self, name, type_data, charge, position):
        self.type_data.setdefault(type_data[0], type_data)
        self.names.append(name)
        self.residue_of.append(len(self.residues) - 1)
        self.types.append(type_data[0])
        self.charges.append(charge)
        self.positions.append(position)
        return len(self.names) - 1

    @property
    def n_atoms(self):
        return len(self.names)

    def is_hydrogen(self, i):
        return self.type_data[self.types[i]][4] == 1


def _lj_sigma_eps(td):
    """(sigma nm, eps kJ/mol) of a type: GAFF's R* in Å and kcal, TIP3P's
    sigma in nm and kJ."""
    name, size, eps = td[0], td[1], td[2]
    if size is None or eps == 0.0:
        return 0.0, 0.0
    if name in GAFF_TYPES:
        return 0.1 * 2.0 * size / 2.0 ** (1.0 / 6.0), eps * KCAL_KJ
    return size, eps


def _section(flag, kind, values):
    fmt, per_line, width = PRMTOP_FORMATS[kind]
    out = [f"%FLAG {flag:<74s}", f"%FORMAT({fmt})"]
    if kind == "a":
        fields = [f"{str(v):<4s}"[:4] for v in values]
    elif kind == "i":
        fields = [f"{int(v):8d}" for v in values]
    else:
        fields = [f"{float(v):16.8E}" for v in values]
    lines = ["".join(fields[i:i + per_line])
             for i in range(0, len(fields), per_line)]
    return out + (lines or [""])


def write_prmtop(path, top: Topology, title="stand-in"):
    """Write ``top`` as an Amber prmtop: every section that
    ``create_system_from_prmtop`` and ``AmberTopology`` read, in the
    standard formats; charges times 18.2223, atom indices times 3, a
    torsion's third index negative when its 1-4 pair is counted by another
    term and its fourth when it is an improper."""
    type_names = list(top.type_data)
    ntypes = len(type_names)
    tindex = {t: k for k, t in enumerate(type_names)}
    # LJ tables over type pairs (Lorentz-Berthelot), A = 4 eps sig^12 and
    # B = 4 eps sig^6 in kcal/mol and Å
    se = [_lj_sigma_eps(top.type_data[t]) for t in type_names]
    acoef, bcoef = [], []
    nb_index = np.zeros((ntypes, ntypes), np.int64)
    for j in range(ntypes):
        for i in range(j + 1):
            (si, ei), (sj, ej) = se[i], se[j]
            eps = math.sqrt(ei * ej) / KCAL_KJ
            sig = 0.5 * (si + sj) * 10.0 if eps > 0 else 0.0
            acoef.append(4.0 * eps * sig ** 12)
            bcoef.append(4.0 * eps * sig ** 6)
            nb_index[i, j] = nb_index[j, i] = len(acoef)
    # parameter types in order of first use
    bond_types, angle_types, tors_types = {}, {}, {}

    def type_of(table, key):
        return table.setdefault(key, len(table) + 1)

    def with_h(*atoms):
        return any(top.is_hydrogen(a) for a in atoms)

    bonds_h, bonds = [], []
    for i, j, t in top.bonds:
        row = (3 * i, 3 * j, type_of(bond_types, t))
        (bonds_h if with_h(i, j) else bonds).append(row)
    angles_h, angles = [], []
    for i, j, k, t in top.angles:
        row = (3 * i, 3 * j, 3 * k, type_of(angle_types, t))
        (angles_h if with_h(i, j, k) else angles).append(row)
    dih_h, dih = [], []
    counted = set()
    for i, j, k, l, term, improper in top.torsions:
        if 0 in (k, l):      # -0 carries no flag: the reversed torsion does
            i, j, k, l = l, k, j, i
        key = (min(i, l), max(i, l))
        no14 = improper or key in counted
        if not improper:
            counted.add(key)
        row = (3 * i, 3 * j, -3 * k if no14 else 3 * k,
               -3 * l if improper else 3 * l, type_of(tors_types, term))
        (dih_h if with_h(i, j, k, l) else dih).append(row)

    n_res = len(top.residues)
    res_sizes = np.diff([first for _, first in top.residues] + [top.n_atoms])
    pointers = [top.n_atoms, ntypes, len(bonds_h), len(bonds), len(angles_h),
                len(angles), len(dih_h), len(dih), 0, 0, 0, n_res,
                len(bonds), len(angles), len(dih), len(bond_types),
                len(angle_types), len(tors_types), ntypes, 0, 0, 0, 0, 0, 0,
                0, 0, 1 if top.box is not None else 0, int(res_sizes.max()),
                0, 0]
    td = [top.type_data[t] for t in top.types]
    bt = sorted(bond_types, key=bond_types.get)
    at = sorted(angle_types, key=angle_types.get)
    tt = sorted(tors_types, key=tors_types.get)
    lines = ["%VERSION  VERSION_STAMP = V0001.000  DATE = 01/01/26  00:00:00"]
    sections = [
        ("TITLE", "a", [title[i:i + 4] for i in range(0, len(title), 4)]),
        ("POINTERS", "i", pointers),
        ("ATOM_NAME", "a", top.names),
        ("CHARGE", "e", [q * AMBER_CHARGE for q in top.charges]),
        ("ATOMIC_NUMBER", "i", [d[4] for d in td]),
        ("MASS", "e", [d[3] for d in td]),
        ("ATOM_TYPE_INDEX", "i", [tindex[t] + 1 for t in top.types]),
        ("NONBONDED_PARM_INDEX", "i", nb_index.reshape(-1)),
        ("RESIDUE_LABEL", "a", [label for label, _ in top.residues]),
        ("RESIDUE_POINTER", "i", [first + 1 for _, first in top.residues]),
        ("BOND_FORCE_CONSTANT", "e", [GAFF_BONDS[t][0] for t in bt]),
        ("BOND_EQUIL_VALUE", "e", [GAFF_BONDS[t][1] for t in bt]),
        ("ANGLE_FORCE_CONSTANT", "e", [GAFF_ANGLES[t][0] for t in at]),
        ("ANGLE_EQUIL_VALUE", "e",
         [math.radians(GAFF_ANGLES[t][1]) for t in at]),
        ("DIHEDRAL_FORCE_CONSTANT", "e", [t[0] for t in tt]),
        ("DIHEDRAL_PERIODICITY", "e", [t[1] for t in tt]),
        ("DIHEDRAL_PHASE", "e", [math.radians(t[2]) for t in tt]),
        ("SCEE_SCALE_FACTOR", "e", [SCEE] * len(tt)),
        ("SCNB_SCALE_FACTOR", "e", [SCNB] * len(tt)),
        ("LENNARD_JONES_ACOEF", "e", acoef),
        ("LENNARD_JONES_BCOEF", "e", bcoef),
        ("BONDS_INC_HYDROGEN", "i", [v for r in bonds_h for v in r]),
        ("BONDS_WITHOUT_HYDROGEN", "i", [v for r in bonds for v in r]),
        ("ANGLES_INC_HYDROGEN", "i", [v for r in angles_h for v in r]),
        ("ANGLES_WITHOUT_HYDROGEN", "i", [v for r in angles for v in r]),
        ("DIHEDRALS_INC_HYDROGEN", "i", [v for r in dih_h for v in r]),
        ("DIHEDRALS_WITHOUT_HYDROGEN", "i", [v for r in dih for v in r]),
        ("AMBER_ATOM_TYPE", "a", top.types),
        ("RADIUS_SET", "a", ["modi", "fied", " Bon", "di r", "adii"]),
        ("RADII", "e", [d[5] for d in td]),
        ("SCREEN", "e", [d[6] for d in td]),
    ]
    if top.box is not None:
        sections.append(("BOX_DIMENSIONS", "e",
                         [90.0] + [10.0 * top.box] * 3))
    for flag, kind, values in sections:
        lines += _section(flag, kind, values)
    pathlib.Path(path).write_text("\n".join(lines) + "\n")


def write_inpcrd(path, positions_nm, box_nm=None):
    """An Amber ASCII restart: title, atom count, 6F12.7 coordinates in Å,
    and with ``box_nm`` the box record (three edges and 90° angles)."""
    x = (10.0 * np.asarray(positions_nm, np.float64)).reshape(-1)
    vals = list(x)
    lines = ["stand-in", f"{len(x) // 3:6d}"]
    lines += ["".join(f"{v:12.7f}" for v in vals[i:i + 6])
              for i in range(0, len(vals), 6)]
    if box_nm is not None:
        lines.append("".join(f"{v:12.7f}" for v in
                             [10.0 * box_nm] * 3 + [90.0] * 3))
    pathlib.Path(path).write_text("\n".join(lines) + "\n")


def write_pdb(path, top: Topology):
    """ATOM records (coordinates in Å, 8.3f)."""
    lines = []
    x = 10.0 * np.asarray(top.positions, np.float64)
    for a in range(top.n_atoms):
        res = top.residue_of[a]
        lines.append(
            f"ATOM  {(a + 1) % 100000:5d} {top.names[a]:<4s} "
            f"{top.residues[res][0]:<3s}  {(res + 1) % 10000:4d}    "
            f"{x[a, 0]:8.3f}{x[a, 1]:8.3f}{x[a, 2]:8.3f}  1.00  0.00")
    lines.append("END")
    pathlib.Path(path).write_text("\n".join(lines) + "\n")


def add_waters(top: Topology, oxygens_and_hydrogens):
    """TIP3P waters (O, H1, H2 positions in nm, (W, 3, 3)): charges, the
    O-H and H-H bonds (in BONDS_INC_HYDROGEN: constrained with h-bonds),
    no angle."""
    for o, h1, h2 in oxygens_and_hydrogens:
        top.add_residue("WAT")
        io = top.add_atom("O", TIP3P_OW, TIP3P_Q[0], o)
        i1 = top.add_atom("H1", TIP3P_HW, TIP3P_Q[1], h1)
        i2 = top.add_atom("H2", TIP3P_HW, TIP3P_Q[1], h2)
        top.bonds += [(io, i1, "OW-HW"), (io, i2, "OW-HW"),
                      (i1, i2, "HW-HW")]


def water_box_topology(box_edge, device="cpu"):
    """The waters of ``PMEWaterBox(box_edge)`` (port) as a Topology, with
    its positions and box (a box under 2 nm takes a shorter cutoff, which
    moves no water)."""
    from openmmtools_tpu_torch.models import PMEWaterBox

    w = PMEWaterBox(box_edge=box_edge, cutoff=min(1.0, 0.49 * box_edge),
                    device=device)
    top = Topology()
    add_waters(top, w.positions.double().cpu().numpy().reshape(-1, 3, 3))
    top.box = float(box_edge)
    return top, w


def alkane_chain(top: Topology, n_carbons, origin, improper=True):
    """One all-trans alkane CnH(2n+2) along x from ``origin`` (nm), its
    carbon zigzag in the x-y plane: GAFF c3/hc bonds, angles and torsions
    (c3-c3-c3-c3 as three terms, X-c3-c3-X one), CH3 and CH2 groups
    neutral, and one improper on the second carbon."""
    bcc, bch = GAFF_BONDS["c3-c3"][1] / 10, GAFF_BONDS["c3-hc"][1] / 10
    theta = math.radians(GAFF_ANGLES["c3-c3-c3"][1])
    dx, dy = bcc * math.sin(theta / 2), bcc * math.cos(theta / 2)
    carbons = [np.asarray(origin) + [k * dx, (k % 2) * dy, 0.0]
               for k in range(n_carbons)]
    top.add_residue("LIG")
    c_idx, h_of = [], []
    for k, c in enumerate(carbons):
        end = k in (0, n_carbons - 1)
        c_idx.append(top.add_atom(f"C{k + 1}", GAFF_TYPES["c3"],
                                  -0.09 if end else -0.06, c))
        nbrs = [carbons[m] for m in (k - 1, k + 1) if 0 <= m < n_carbons]
        units = [(n - c) / np.linalg.norm(n - c) for n in nbrs]
        away = -sum(units)
        away /= np.linalg.norm(away)
        z = np.array([0.0, 0.0, 1.0])
        if end:
            # CH3: one H in the zigzag plane, away from the chain, and two
            # out of it, at the tetrahedral angle from the C-C bond
            u = units[0]
            perp = np.cross(z, u)
            perp *= np.sign(np.dot(perp, away - np.dot(away, u) * u) or 1.0)
            a = math.radians(GAFF_ANGLES["c3-c3-hc"][1])
            dirs = [u * math.cos(a) + math.sin(a) * (
                math.cos(phi) * perp + math.sin(phi) * z)
                for phi in (0.0, 2 * math.pi / 3, -2 * math.pi / 3)]
        else:
            half = math.radians(GAFF_ANGLES["hc-c3-hc"][1]) / 2
            dirs = [away * math.cos(half) + s * z * math.sin(half)
                    for s in (1.0, -1.0)]
        hs = [top.add_atom(f"H{k + 1}{m + 1}"[:4], GAFF_TYPES["hc"], 0.03,
                           c + bch * d) for m, d in enumerate(dirs)]
        h_of.append(hs)
    neighbours = {a: [] for a in c_idx}
    for k in range(n_carbons - 1):
        top.bonds.append((c_idx[k], c_idx[k + 1], "c3-c3"))
        neighbours[c_idx[k]].append(c_idx[k + 1])
        neighbours[c_idx[k + 1]].append(c_idx[k])
    for k, hs in enumerate(h_of):
        for h in hs:
            top.bonds.append((c_idx[k], h, "c3-hc"))
            neighbours[c_idx[k]].append(h)
            neighbours[h] = [c_idx[k]]

    def angle_type(a, b, c):
        ends = sorted("hc" if top.is_hydrogen(t) else "c3" for t in (a, c))
        return {("c3", "c3"): "c3-c3-c3", ("c3", "hc"): "c3-c3-hc",
                ("hc", "hc"): "hc-c3-hc"}[tuple(ends)]

    for b in c_idx:
        nb = neighbours[b]
        for p in range(len(nb)):
            for q in range(p + 1, len(nb)):
                top.angles.append((nb[p], b, nb[q],
                                   angle_type(nb[p], b, nb[q])))
    for k in range(n_carbons - 1):
        j, kk = c_idx[k], c_idx[k + 1]
        for i in neighbours[j]:
            if i == kk:
                continue
            for l in neighbours[kk]:
                if l == j:
                    continue
                if top.is_hydrogen(i) or top.is_hydrogen(l):
                    top.torsions.append((i, j, kk, l, GAFF_XCCX, False))
                else:
                    top.torsions += [(i, j, kk, l, t, False)
                                     for t in GAFF_CCCC]
    if improper and n_carbons >= 3:
        top.torsions.append((c_idx[0], c_idx[2], c_idx[1], h_of[1][0],
                             IMPROPER, True))
    return c_idx[0], top.n_atoms


def solvated_chains(n_chains, n_carbons, box_edge, clearance=0.25,
                    spacing=0.48):
    """The stand-in: ``n_chains`` all-trans alkanes along x, in a bundle on
    a (y, z) grid ``spacing`` apart in the middle of the box, in the waters
    of ``PMEWaterBox(box_edge)`` less those with an atom within
    ``clearance`` nm of a solute atom. Returns the Topology."""
    from scipy.spatial import cKDTree

    top = Topology()
    ny = max(1, int(math.ceil(math.sqrt(n_chains))))
    nz = -(-n_chains // ny)
    bcc = GAFF_BONDS["c3-c3"][1] / 10
    length = (n_carbons - 1) * bcc * math.sin(
        math.radians(GAFF_ANGLES["c3-c3-c3"][1]) / 2)
    c = 0.5 * box_edge
    for m in range(n_chains):
        iy, iz = m % ny, m // ny
        origin = [c - 0.5 * length, c + (iy - 0.5 * (ny - 1)) * spacing,
                  c + (iz - 0.5 * (nz - 1)) * spacing]
        alkane_chain(top, n_carbons, origin)
    solute = np.asarray(top.positions)
    water, _ = water_box_topology(box_edge)
    wx = np.asarray(water.positions).reshape(-1, 3, 3)
    tree = cKDTree(np.mod(solute, box_edge), boxsize=box_edge)
    near = tree.query_ball_point(np.mod(wx.reshape(-1, 3), box_edge),
                                 clearance)
    clash = np.asarray([len(h) > 0 for h in near]).reshape(-1, 3).any(1)
    add_waters(top, wx[~clash])
    top.box = float(box_edge)
    return top


def vacuum_chain(n_carbons=6):
    """One alkane in vacuum (GB radii and screens included)."""
    top = Topology()
    alkane_chain(top, n_carbons, [0.0, 0.0, 0.0])
    return top


def write_system(directory, prmtop, coordinates, top, kind="inpcrd",
                 box_record=True):
    """Write ``top`` as ``directory/prmtop`` and its positions as
    ``directory/coordinates`` (an inpcrd, with the box record when the
    system is periodic and ``box_record``, or a PDB)."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    write_prmtop(directory / prmtop, top)
    if kind == "pdb":
        write_pdb(directory / coordinates, top)
    else:
        write_inpcrd(directory / coordinates, top.positions,
                     top.box if box_record else None)


# the reference's data layout: (subdirectory, prmtop, coordinates) of each
# file pair the prmtop systems read, and which stand-in fills it
VACUUM_FILES = [("alanine-dipeptide-gbsa", "alanine-dipeptide.prmtop",
                 "alanine-dipeptide.crd"),
                ("cb7-b2", "complex-vacuum.prmtop", "complex-vacuum.inpcrd"),
                ("T4-lysozyme-L99A-implicit", "complex.prmtop", "complex.crd"),
                ("benzene-toluene-implicit", "complex.prmtop",
                 "complex.inpcrd"),
                ("benzene-toluene-implicit", "solvent.prmtop",
                 "solvent.inpcrd")]
EXPLICIT_FILES = [("alanine-dipeptide-explicit", "alanine-dipeptide.prmtop",
                   "alanine-dipeptide.crd"),
                  ("cb7-b2", "complex-explicit.prmtop",
                   "complex-explicit.inpcrd"),
                  ("dna_dodecamer_explicit", "prmtop", "inpcrd"),
                  ("methanol-box", "methanol-box.prmtop",
                   "methanol-box.crd")]


def write_stand_in_tree(root, vacuum=None, explicit=None, dhfr=None):
    """Fill ``root`` with stand-ins at the paths the prmtop systems read:
    ``vacuum`` (default: one hexane) at every vacuum/implicit pair,
    ``explicit`` (default: 2 hexanes in PMEWaterBox(2.0)'s waters) at every
    explicit pair, and ``dhfr`` (default: ``explicit``) at
    dhfr/JAC.prmtop + system.pdb. Returns the three topologies."""
    vacuum = vacuum or vacuum_chain()
    explicit = explicit or solvated_chains(2, 6, 2.0)
    dhfr = dhfr or explicit
    for sub, prmtop, crd in VACUUM_FILES:
        write_system(pathlib.Path(root) / sub, prmtop, crd, vacuum)
    for sub, prmtop, crd in EXPLICIT_FILES:
        write_system(pathlib.Path(root) / sub, prmtop, crd, explicit)
    write_system(pathlib.Path(root) / "dhfr", "JAC.prmtop", "system.pdb",
                 dhfr, kind="pdb")
    return vacuum, explicit, dhfr


# -- phase 19: every move tree as one batch of replicas ----------------------

ALCH_WATER = [0, 1, 2]     # the alchemical water of AlchemicalWaterBox
TREE_ITERATIONS = 3        # 19a
TREE_REPLICAS = [0, 4, 8]  # 19b
NPT_ITERATIONS = 3         # 19c
NPT_ATTEMPTS = 5
# 19c: a ln V step of +-0.003, about one standard deviation of the volume
# of 8,000 waters at 1 bar (kT kappa / V), so that about half the attempts
# are accepted
NPT_VOLUME_SCALE = 0.003
PER_STATE_STEPS = 20       # 19d: each per-state Langevin move's steps
WEIGHTED_STEPS = 10        # 19d: the Langevin move after the WeightedMove


def ligand_tree():
    """19a's move: a displacement and a rotation of the alchemical water,
    then 14a's Langevin move (YANK's ligand moves)."""
    from openmmtools_tpu_torch.mcmc import (
        MCDisplacementMove,
        MCRotationMove,
        SequenceMove,
    )

    return SequenceMove([MCDisplacementMove(atom_subset=ALCH_WATER),
                         MCRotationMove(atom_subset=ALCH_WATER),
                         water_move()])


def tree_kernels(integrator_moves, states):
    """The K2 kernels a move tree launches at ``states`` (of one system):
    those of its integrator moves' bound integrators at each state (a
    Langevin move binds an integrator a temperature, and a batch takes its
    first replica's) and that of the global context cache's bound
    integrator, which evaluates the Monte Carlo moves."""
    from openmmtools_tpu_torch.cache import global_context_cache

    bounds = [m._bound(st) for m in integrator_moves for st in states]
    bounds.append(global_context_cache.get_context(states[0])[0])
    assert all(b.sweep_mode for b in bounds)
    return list({id(b._sweep_kernel): b._sweep_kernel
                 for b in bounds}.values())


def reset_counts(kernels):
    for k in kernels:
        for key in k.launches:
            k.launches[key] = 0
        k.batch_launches.clear()


def merged_counts(kernels):
    """(launches by kernel, launches by (kernel, batch size)) summed over
    ``kernels``."""
    launches = collections.Counter()
    by_batch = collections.Counter()
    for k in kernels:
        launches.update(k.launches)
        by_batch.update(k.batch_launches)
    return dict(launches), dict(by_batch)


def batch_key(by_batch):
    return {f"{key} x{b}": c for (key, b), c in sorted(by_batch.items())}


def phase_tree_batched(dev, smi, re_sampler, eager17b):
    """19a: replica exchange on the ladder with a displacement, a rotation
    and the Langevin move as one SequenceMove: the batched route, K2 by
    batch size, against one iteration of the eager loop on the same
    tree."""
    from openmmtools_tpu_torch.multistate import ReplicaExchangeSampler

    states = re_sampler._thermodynamic_states
    n_states = len(states)

    def sampler_of(move, n_iterations):
        sampler = ReplicaExchangeSampler(
            mcmc_moves=move, number_of_iterations=n_iterations,
            online_analysis_interval=None, replica_mixing_scheme="swap-all",
            rng_seed=19)
        sampler.create(states, re_sampler.sampler_states)
        return sampler

    move = ligand_tree()
    kernels = tree_kernels([move.move_list[2]], states)
    sampler = sampler_of(move, TREE_ITERATIONS)
    n = sampler.n_replicas
    assert sampler.propagation_route == "batched"
    reset_counts(kernels)
    t0 = time.perf_counter()
    sampler.run(TREE_ITERATIONS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_batch = merged_counts(kernels)
    u = sampler.energies_last_iteration
    assert u.shape == (n, n_states) and np.isfinite(u).all()
    it = TREE_ITERATIONS
    want = {("sweep_bound", 2 * n): 2 * it,
            ("sweep_forces_alch", 2 * n): 2 * it,
            ("sweep_bound", n): (MS_STEPS + 2) * it,
            ("sweep_forces_alch", n): (MS_STEPS + 1) * it,
            ("sweep_forces_alch", n * n_states): it}
    assert by_batch == want, by_batch
    per_iteration = {key: c // it for key, c in launches.items()}
    assert per_iteration == {"sweep_bound": MS_STEPS + 4,
                             "sweep_forces_alch": MS_STEPS + 4}, launches
    disp, rot = move.move_list[0], move.move_list[1]
    split = split_means(sampler, 0)
    it_s = wall / it

    # the eager loop on the same tree, its Monte Carlo moves wrapped so
    # that it cannot batch
    inner = ligand_tree()
    eager_kernels = tree_kernels([inner.move_list[2]], states)
    inner.move_list[:2] = [apply_only(m) for m in inner.move_list[:2]]
    eager = sampler_of(inner, 1)
    assert eager.propagation_route == "eager"
    reset_counts(eager_kernels)
    t0 = time.perf_counter()
    eager.run(1)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    eager_launches, eager_batch = merged_counts(eager_kernels)
    eager_want = {("sweep_bound", 2): 2 * n, ("sweep_forces_alch", 2): 2 * n,
                  ("sweep_bound", 1): (MS_STEPS + 1) * n,
                  ("sweep_forces_alch", 1): (MS_STEPS + 1) * n,
                  ("sweep_bound", n): 1,
                  ("sweep_forces_alch", n * n_states): 1}
    assert eager_batch == eager_want, eager_batch
    say(f"phase 19a RE on the ladder ({n} replicas) with SequenceMove("
        f"displacement, rotation of the alchemical water, Langevin "
        f"{MS_STEPS} steps), {sampler.propagation_route} route: {it} "
        f"iterations in {wall:.2f} s, {it_s:.3f} s an iteration (mixing "
        f"{split['mixing']:.4f}, propagation {split['propagation']:.3f}, "
        f"matrix {split['energy_matrix']:.3f}); K2 launches an iteration "
        f"{per_iteration} by batch size "
        f"{ {k: c // it for k, c in batch_key(by_batch).items()} }; the "
        f"eager loop on the same tree: {eager_launches} by batch size "
        f"{batch_key(eager_batch)} in one iteration of {eager_s:.2f} s "
        f"(17b's eager iteration, 10 steps: {eager17b['iteration_s']:.2f} "
        f"s); acceptance: displacement {disp.n_accepted}/{disp.n_proposed},"
        f" rotation {rot.n_accepted}/{rot.n_proposed} ({smi})")
    assert disp.n_proposed == rot.n_proposed == n * it
    return dict(route=sampler.propagation_route, iterations=it,
                seconds_per_iteration=it_s, split_s=split,
                launches_per_iteration=per_iteration,
                batch_launches=batch_key(by_batch),
                eager_seconds_per_iteration=eager_s,
                eager_launches=eager_launches,
                eager_batch_launches=batch_key(eager_batch),
                displacement=[disp.n_accepted, disp.n_proposed],
                rotation=[rot.n_accepted, rot.n_proposed])


def phase_tree_against_eager(dev, smi, re_sampler):
    """19b: 3 replicas of the ladder, one application of 19a's tree as one
    batch and one apply a replica, with the same generators: each
    replica's accept decisions (counted on a tree of its own) and its
    positions."""
    states = re_sampler._thermodynamic_states
    sss = [re_sampler.sampler_states[i] for i in TREE_REPLICAS]
    ts = [states[int(re_sampler.replica_states[i])] for i in TREE_REPLICAS]

    def gens():
        return [torch.Generator(device=dev).manual_seed(190 + i)
                for i in range(len(TREE_REPLICAS))]

    def decisions(tree):
        return [tree.move_list[0].n_accepted, tree.move_list[1].n_accepted]

    batch_move = ligand_tree()
    owners = [ligand_tree() for _ in TREE_REPLICAS]
    eager_move = ligand_tree()
    batch_move.move_list[2]._bound(ts[0])
    eager_move.move_list[2]._bound(ts[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = batch_move.apply_batch(ts, sss, gens(), owners=owners)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    eager, eager_decisions = [], []
    t0 = time.perf_counter()
    for st, ss, gen in zip(ts, sss, gens()):
        before = decisions(eager_move)
        eager.append(eager_move.apply(st, ss, generator=gen))
        eager_decisions.append([a - b for a, b in
                                zip(decisions(eager_move), before)])
    torch.cuda.synchronize()
    t_eager = time.perf_counter() - t0
    batch_decisions = [decisions(o) for o in owners]
    bits = [torch.equal(a.positions, b.positions) for a, b in zip(out, eager)]
    rel = max(max_rel(a.positions, b.positions) for a, b in zip(out, eager))
    say(f"phase 19b {len(TREE_REPLICAS)} replicas, one application of 19a's"
        f" tree: batched {t_batch:.2f} s, one apply a replica {t_eager:.2f} "
        f"s; accept decisions (displacement, rotation) a replica batched "
        f"{batch_decisions}, eager {eager_decisions}; positions bit-equal "
        f"{bits}, worst rel {rel:.2e} ({smi})")
    assert batch_decisions == eager_decisions
    assert rel <= REL_TOL, rel
    return dict(batched_s=t_batch, eager_s=t_eager,
                decisions=batch_decisions, bit_equal=bits, positions_rel=rel)


def npt_pt_sampler(w, moves):
    """19c's NPT parallel tempering of the water box ``w`` under the move
    tree ``moves``: 15b's temperatures at 1 bar, 'swap-neighbors', created
    and FIRE-minimized; (the sampler, the set-up seconds)."""
    from openmmtools_tpu_torch.multistate import ParallelTemperingSampler

    sampler = ParallelTemperingSampler(
        mcmc_moves=moves, number_of_iterations=NPT_ITERATIONS,
        online_analysis_interval=None,
        replica_mixing_scheme="swap-neighbors", rng_seed=193)
    t0 = time.perf_counter()
    sampler.create(w.thermodynamic_state(WATER_T, pressure=EQ_PRESSURE),
                   w.sampler_state(), temperatures=PT_WATER_TEMPERATURES)
    sampler.minimize(max_iterations=MS_FIRE_STEPS)
    return sampler, time.perf_counter() - t0


def npt_launches(n, iterations):
    """K2's launches by (kernel, batch size) of ``iterations`` of the NPT
    tree on ``n`` replicas: each barostat attempt one launch of each kernel
    at B = 2n; the dynamics ``PT_WATER_STEPS`` + 1 and the energy matrix
    one at B = n."""
    return {("sweep_bound", 2 * n): NPT_ATTEMPTS * iterations,
            ("sweep_forces", 2 * n): NPT_ATTEMPTS * iterations,
            ("sweep_bound", n): (PT_WATER_STEPS + 2) * iterations,
            ("sweep_forces", n): (PT_WATER_STEPS + 2) * iterations}


def phase_npt_tree(dev, smi):
    """19c: NPT parallel tempering on the water box with the barostat in
    the move tree: K2 at B = 2R an attempt, per-replica boxes, rigid
    waters, U at the final boxes against each replica alone. Returns the
    sampler (20a reads its replicas) and the phase's numbers."""
    from openmmtools_tpu_torch.constants import BAR_TO_KJ_PER_MOL_NM3
    from openmmtools_tpu_torch.mcmc import (
        LangevinDynamicsMove,
        MonteCarloBarostatMove,
        SequenceMove,
    )
    from openmmtools_tpu_torch.models import PMEWaterBox
    from openmmtools_tpu_torch.system import volume

    w = PMEWaterBox(box_edge=WATER_EDGE, device=dev)
    langevin = LangevinDynamicsMove(timestep=0.002, collision_rate=1.0,
                                    n_steps=PT_WATER_STEPS)
    baro = MonteCarloBarostatMove(volume_scale=NPT_VOLUME_SCALE,
                                  n_attempts=NPT_ATTEMPTS)
    sampler, t_setup = npt_pt_sampler(w, SequenceMove([langevin, baro]))
    n = sampler.n_replicas
    states = sampler._thermodynamic_states
    assert sampler.propagation_route == "batched"
    kernels = tree_kernels([langevin], states)
    reset_counts(kernels)
    t0 = time.perf_counter()
    sampler.run(NPT_ITERATIONS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _, by_batch = merged_counts(kernels)
    it = NPT_ITERATIONS
    assert by_batch == npt_launches(n, it), by_batch
    u = sampler.energies_last_iteration
    s = sampler.replica_states
    beta = sampler._stacked_sampled.beta.numpy()
    p = EQ_PRESSURE * BAR_TO_KJ_PER_MOL_NM3
    edges, worst_bond, worst_u = [], 0.0, 0.0
    bound = sampler._matrix_bound()
    for r, ss in enumerate(sampler.sampler_states):
        edges.append(float(ss.box_vectors[0, 0]))
        worst_bond = max(worst_bond, bond_error(w.system, ss.positions,
                                                ss.box_vectors))
        (U,) = plain_energies(bound, [ss], {})
        U_run = float(u[r, s[r]]) / beta[s[r]] - p * float(
            volume(ss.box_vectors))
        worst_u = max(worst_u, abs(U_run - U) / abs(U))
    say(f"phase 19c NPT PT on PMEWaterBox({WATER_EDGE}) at "
        f"{PT_WATER_TEMPERATURES} K and {EQ_PRESSURE} bar, SequenceMove("
        f"Langevin {PT_WATER_STEPS} steps, barostat {NPT_ATTEMPTS} attempts "
        f"of +-{NPT_VOLUME_SCALE} in ln V): set-up {t_setup:.2f} s, {it} "
        f"iterations in {wall:.2f} s ({wall / it:.3f} s an iteration); K2 "
        f"by batch size {batch_key(by_batch)}; barostat {baro.n_accepted}/"
        f"{baro.n_proposed} accepted; box edges {edges} nm; worst relative "
        f"bond-length error {worst_bond:.2e}; U at the final boxes against "
        f"the plain sweep plus the remainder of each replica alone: worst "
        f"rel {worst_u:.2e} ({smi})")
    assert len(set(edges)) > 1, edges
    assert worst_bond <= 1e-5, worst_bond
    assert worst_u <= REL_TOL, worst_u
    return sampler, dict(
        replicas=n, iterations=it, setup_s=t_setup,
        seconds_per_iteration=wall / it, batch_launches=batch_key(by_batch),
        barostat=[baro.n_accepted, baro.n_proposed], box_edges=edges,
        bond_error=worst_bond, u_rel=worst_u)


def phase_per_state_moves(dev, smi, re_sampler):
    """19d: per-state moves (two Langevin moves of different timesteps:
    two batched groups) and a WeightedMove of the displacement and the
    rotation (branch groups), one iteration each on the ladder."""
    from openmmtools_tpu_torch.mcmc import (
        LangevinSplittingDynamicsMove,
        MCDisplacementMove,
        MCRotationMove,
        SequenceMove,
        WeightedMove,
    )
    from openmmtools_tpu_torch.multistate import MultiStateSampler

    states = re_sampler._thermodynamic_states
    n_states = len(states)

    def langevin(timestep, n_steps):
        return LangevinSplittingDynamicsMove(
            timestep=timestep, collision_rate=1.0, n_steps=n_steps,
            splitting="V R O R V")

    def run_one(moves, seed):
        sampler = MultiStateSampler(mcmc_moves=moves, number_of_iterations=1,
                                    online_analysis_interval=None,
                                    rng_seed=seed)
        sampler.create(states, re_sampler.sampler_states)
        assert sampler.propagation_route == "batched"
        return sampler

    a, b = langevin(0.002, PER_STATE_STEPS), langevin(0.001, PER_STATE_STEPS)
    moves = [a] * 5 + [b] * (n_states - 5)
    sampler = run_one(moves, 194)
    n = sampler.n_replicas
    s_of = sampler.replica_states.tolist()
    groups = MultiStateSampler.move_groups(moves, s_of)
    assert [len(g) for g in groups] == [5, n - 5], groups
    kernels = tree_kernels([a, b], states)
    reset_counts(kernels)
    t0 = time.perf_counter()
    sampler.run(1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _, by_batch = merged_counts(kernels)
    want = {("sweep_bound", 5): PER_STATE_STEPS + 1,
            ("sweep_forces_alch", 5): PER_STATE_STEPS + 1,
            ("sweep_bound", n - 5): PER_STATE_STEPS + 1,
            ("sweep_forces_alch", n - 5): PER_STATE_STEPS + 1,
            ("sweep_bound", n): 1, ("sweep_forces_alch", n * n_states): 1}
    assert by_batch == want, by_batch
    assert np.isfinite(sampler.energies_last_iteration).all()
    say(f"phase 19d per-state moves on the ladder (states 0-4 Langevin 2 fs,"
        f" 5-8 1 fs, {PER_STATE_STEPS} steps): groups of "
        f"{[len(g) for g in groups]} replicas, one iteration {wall:.2f} s; "
        f"K2 by batch size {batch_key(by_batch)} ({smi})")

    disp = MCDisplacementMove(atom_subset=ALCH_WATER)
    rot = MCRotationMove(atom_subset=ALCH_WATER)
    sizes = {"displacement": [], "rotation": []}
    for name, move in (("displacement", disp), ("rotation", rot)):
        def recorded(ts, sss, gens, *args, _apply=move.apply_batch,
                     _sizes=sizes[name], **kwargs):
            _sizes.append(len(sss))
            return _apply(ts, sss, gens, *args, **kwargs)
        move.apply_batch = recorded
    dynamics = langevin(0.002, WEIGHTED_STEPS)
    tree = SequenceMove([WeightedMove([(disp, 0.5), (rot, 0.5)]), dynamics])
    sampler = run_one(tree, 195)
    kernels = tree_kernels([dynamics], states)
    reset_counts(kernels)
    t0 = time.perf_counter()
    sampler.run(1)
    torch.cuda.synchronize()
    wall_w = time.perf_counter() - t0
    _, by_batch_w = merged_counts(kernels)
    n_disp = sum(sizes["displacement"])
    n_rot = sum(sizes["rotation"])
    say(f"phase 19d WeightedMove(displacement, rotation) then Langevin "
        f"{WEIGHTED_STEPS} steps: branch groups displacement "
        f"{sizes['displacement']}, rotation {sizes['rotation']} "
        f"(sum {n_disp + n_rot}); one iteration {wall_w:.2f} s; K2 by batch "
        f"size {batch_key(by_batch_w)}; accepted displacement "
        f"{disp.n_accepted}/{disp.n_proposed}, rotation {rot.n_accepted}/"
        f"{rot.n_proposed} ({smi})")
    assert n_disp + n_rot == n
    for name, count in (("displacement", n_disp), ("rotation", n_rot)):
        if count:
            assert by_batch_w[("sweep_forces_alch", 2 * count)] >= 1, name
    return dict(groups=[len(g) for g in groups], iteration_s=wall,
                batch_launches=batch_key(by_batch),
                weighted_groups=[n_disp, n_rot], weighted_iteration_s=wall_w,
                weighted_batch_launches=batch_key(by_batch_w))


def phase_native_parser(root, smi):
    """19e: the native prmtop parser on 18a's JAC-size stand-in: a fresh
    build (into a temporary directory), the parse seconds native and in
    pure Python (median of 3), every section equal."""
    from openmmtools_tpu_torch.models import amber
    from openmmtools_tpu_torch.ops import _build

    path = str(root / "dhfr" / "JAC.prmtop")
    saved = _build.BUILD_DIR
    with tempfile.TemporaryDirectory() as tmp:
        _build.BUILD_DIR = pathlib.Path(tmp)
        try:
            t0 = time.perf_counter()
            _build.host_library("prmtop_parser")
            t_build = time.perf_counter() - t0
        finally:
            _build.BUILD_DIR = saved

    def timed(fn):
        times, out = [], None
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn(path)
            times.append(time.perf_counter() - t0)
        return statistics.median(times), out

    amber.parse_prmtop(path)        # the checkout's library, built once
    t_native, native = timed(amber.parse_prmtop)
    t_python, python = timed(amber.parse_prmtop_python)
    assert list(native) == list(python)
    for flag, values in native.items():
        assert values.dtype == python[flag].dtype, flag
        assert np.array_equal(values, python[flag]), flag
    say(f"phase 19e the native prmtop parser on the JAC-size stand-in "
        f"({pathlib.Path(path).stat().st_size / 1e6:.1f} MB, {len(native)} "
        f"sections, every one equal to the pure-Python parse's): a fresh "
        f"build {t_build:.2f} s; the parse {t_native:.4f} s native, "
        f"{t_python:.4f} s in pure Python (median of 3; "
        f"{t_python / t_native:.1f}x) on the card machine's host ({smi})")
    return dict(build_s=t_build, native_s=t_native, python_s=t_python,
                sections=len(native))


# -- phase 18: the loader's explicit-solvent path at JAC's size --------------

JAC_CHAINS = 40          # 18a: all-trans eicosanes, C20H42, 62 atoms each
JAC_CARBONS = 20
JAC_STEPS = 1_000        # 18c: the main path's steps, in chunks
JAC_CHUNK = 500
JAC_MIN_ITERATIONS = 100
STAND_IN = "JAC-size stand-in, not DHFR"
JAC_U_REL = 1e-5         # 18b-18c: U against the reference
DHFR_JAC_ARGS = ["--steps", "200", "--no-check"]
DHFR_REFERENCE_ARGS = ["--steps", "500", "--reference-defaults"]
REMD_CUT = ["--replicas", "16", "--steps", "50", "--iters", "3"]


def plain64(system):
    """A bound integrator of ``system`` in float64 on the CPU in sweep mode:
    the kernels' plain versions (the card refuses the dense sum at this
    size)."""
    from openmmtools_tpu_torch.integrators import BAOABIntegrator

    bound = BAOABIntegrator(temperature=WATER_T, sweep="force").bind(
        system.to(device="cpu", dtype=torch.float64))
    assert bound.sweep_mode
    return bound


def plain64_u_f(bound64, x, box):
    return bound64.energy_forces_at(x.detach().cpu().double(),
                                    box.detach().cpu().double(), {})


def phase_stand_ins(root, smi):
    """18a: the water-only prmtop of PMEWaterBox(6.223), the JAC-size
    stand-in at dhfr/ and the vacuum one at alanine-dipeptide-gbsa/; the
    pure-Python parse of the stand-in, timed."""
    from openmmtools_tpu_torch.models import amber

    t0 = time.perf_counter()
    water, _ = water_box_topology(WATER_EDGE)
    (root / "water").mkdir(parents=True)
    write_prmtop(root / "water" / "water.prmtop", water, "PMEWaterBox")
    jac = solvated_chains(JAC_CHAINS, JAC_CARBONS, WATER_EDGE)
    write_system(root / "dhfr", "JAC.prmtop", "system.pdb", jac, kind="pdb")
    write_system(root / "alanine-dipeptide-gbsa", "alanine-dipeptide.prmtop",
                 "alanine-dipeptide.crd", vacuum_chain())
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = amber.parse_prmtop_python(str(root / "dhfr" / "JAC.prmtop"))
    t_parse = time.perf_counter() - t0
    n_solute = JAC_CHAINS * (3 * JAC_CARBONS + 2)
    n_waters = (jac.n_atoms - n_solute) // 3
    assert int(data["POINTERS"][0]) == jac.n_atoms == n_solute + 3 * n_waters
    size = (root / "dhfr" / "JAC.prmtop").stat().st_size
    say(f"phase 18a {STAND_IN}: {jac.n_atoms} atoms ({JAC_CHAINS} eicosanes, "
        f"{n_solute} solute atoms, {n_waters} TIP3P waters of "
        f"PMEWaterBox({WATER_EDGE})), {len(jac.bonds)} bonds, "
        f"{len(jac.angles)} angles, {len(jac.torsions)} torsion terms; "
        f"the water-only prmtop {water.n_atoms} atoms; written in "
        f"{t_write:.2f} s; the pure-Python parse of the {size / 1e6:.1f} MB "
        f"stand-in prmtop {t_parse:.3f} s on the card machine's host ({smi})")
    return dict(atoms=jac.n_atoms, solute_atoms=n_solute, waters=n_waters,
                write_s=t_write, parse_s=t_parse, prmtop_mb=size / 1e6)


def phase_loader_water(dev, smi, root):
    """18b: the water-only prmtop through the loader against
    PMEWaterBox(6.223) at its positions, both bound on the card (K2): the
    whole U and F, the reciprocal term's (float64 on the card), and the
    direct space's (the rest: the exclusions' add-back is zero)."""
    from openmmtools_tpu_torch.integrators import BAOABIntegrator
    from openmmtools_tpu_torch.models import PMEWaterBox, amber
    from openmmtools_tpu_torch.ops.pme import (
        DEFAULT_EWALD_ERROR_TOLERANCE,
        EwaldReciprocalTerm,
    )
    from openmmtools_tpu_torch.system import value_and_grad

    w = PMEWaterBox(box_edge=WATER_EDGE, device=dev)
    term = w.system.terms[0]
    loaded = amber.create_system_from_prmtop(
        str(root / "water" / "water.prmtop"), nonbonded_method="pme",
        cutoff=term.cutoff, switch_width=term.switch_width,
        ewald_error_tolerance=DEFAULT_EWALD_ERROR_TOLERANCE, device=dev)
    x, box = w.positions, w.system.default_box
    parts = {}
    for label, system in (("loader", loaded), ("PMEWaterBox", w.system)):
        bound = BAOABIntegrator(temperature=WATER_T).bind(system)
        assert bound.sweep_mode and bound._sweep_recip is not None
        assert bound._settle is not None and bound._rest_constraints is None
        k = bound._sweep_kernel
        before = dict(k.launches)
        u, f = bound.energy_forces_at(x, box, {})
        assert all(k.launches[key] > before[key] for key in k.launches)
        # the reciprocal term alone in float64 (in float32 its self energy
        # and exclusion correction, -2e6 and +2e6 kJ/mol here, round to 0.25
        # of it), and the direct space the rest of the K2 path's total
        rec = next(t for t in system.terms
                   if isinstance(t, EwaldReciprocalTerm)).to(
            dtype=torch.float64)
        u_rec, g_rec = value_and_grad(
            lambda xx: rec.energy(xx, box.double()), x.double())
        parts[label] = dict(total=(u, f), reciprocal=(u_rec, -g_rec),
                            direct=(u - u_rec, f.double() + g_rec))
    out = {}
    for part in ("total", "reciprocal", "direct"):
        (u_l, f_l), (u_w, f_w) = parts["loader"][part], parts[
            "PMEWaterBox"][part]
        u_rel, f_rel = _u_f_rel(u_l, f_l, u_w, f_w)
        out[part] = [u_rel, f_rel]
        say(f"phase 18b loader vs PMEWaterBox({WATER_EDGE}) on K2, {part}: "
            f"U {float(u_l):.4f} vs {float(u_w):.4f} (rel {u_rel:.2e}), F "
            f"rel {f_rel:.2e}")
        assert u_rel <= JAC_U_REL and f_rel <= REL_TOL, (part, u_rel, f_rel)
    return out


def phase_jac_path(dev, smi, root):
    """18c: DHFRExplicit(data_dir=<the stand-in>) -> BAOABIntegrator(300 K,
    1/ps, 2 fs) -> bind (sweep mode, K2's standard variant, SETTLE +
    M-SHAKE, the reciprocal correction fused) -> minimize (FIRE on K2,
    through the context cache) -> initial_state -> run JAC_STEPS steps in
    chunks that each end in a host fetch; launches steps + 1, no overflow,
    the constraints to 1e-5, U and F against CPU float64 at the start and
    the end; a profile of the step; K2's force kernel at the final state
    against its plain version, timed."""
    from openmmtools_tpu_torch.integrators import BAOABIntegrator, minimize
    from openmmtools_tpu_torch.models import DHFRExplicit
    from openmmtools_tpu_torch.ops import sweep_nb as tsw

    t0 = time.perf_counter()
    d = DHFRExplicit(data_dir=str(root), device=dev)
    t_build = time.perf_counter() - t0
    system = d.system
    n = system.n_particles
    t0 = time.perf_counter()
    bound = BAOABIntegrator(temperature=WATER_T, collision_rate=1.0,
                            timestep=0.002).bind(system)
    t_bind = time.perf_counter() - t0
    k = bound._sweep_kernel
    assert bound.sweep_mode and bound._sweep_alch is None
    assert k.forces_kernel == "sweep_forces" and bound._fused is None
    n_waters = (n - JAC_CHAINS * (3 * JAC_CARBONS + 2)) // 3
    assert bound._settle.a.shape[0] == n_waters
    # M-SHAKE on the CH3 (3 constraints) and CH2 (2) clusters
    assert bound._clusters is not None
    assert bound._rest_constraints.n_constraints == JAC_CHAINS * (
        2 * JAC_CARBONS + 2)
    assert bound._sweep_recip is system.terms[4]
    term = system.terms[3]
    n_exc = term.exception_index.shape[0]
    say(f"phase 18c {STAND_IN}: {n} atoms, {n_exc} exceptions (1-2, 1-3 "
        f"excluded and scaled 1-4), {system.constraints.n_constraints} "
        f"constraints ({n_waters} SETTLE waters, M-SHAKE on "
        f"{bound._rest_constraints.n_constraints} C-H bonds), n_pad "
        f"{k.n_pad}, mask_shells {k.mask_shells}, PME kmax "
        f"{system.terms[4].kmax}; sweep mode with K2's standard variant and "
        f"the reciprocal correction fused; built in {t_build:.2f} s, bound "
        f"in {t_bind:.2f} s")

    t0 = time.perf_counter()
    ref = plain64(system)
    t_ref_bind = time.perf_counter() - t0
    box = system.default_box
    u0, f0 = bound.energy_forces_at(d.positions, box, {})
    t0 = time.perf_counter()
    u0_ref, f0_ref = plain64_u_f(ref, d.positions, box)
    t_ref = time.perf_counter() - t0
    u_rel0, f_rel0 = _u_f_rel(u0, f0, u0_ref, f0_ref)
    say(f"phase 18c initial U {float(u0):.4f} vs CPU float64 plain "
        f"{float(u0_ref):.4f} (rel {u_rel0:.2e}), F rel {f_rel0:.2e}; the "
        f"CPU float64 bind {t_ref_bind:.2f} s, an evaluation {t_ref:.2f} s")
    assert u_rel0 <= JAC_U_REL and f_rel0 <= REL_TOL, (u_rel0, f_rel0)

    t0 = time.perf_counter()
    ss = minimize(d.thermodynamic_state(WATER_T), d.sampler_state(),
                  max_iterations=JAC_MIN_ITERATIONS)
    torch.cuda.synchronize()
    t_min = time.perf_counter() - t0
    u_min = float(bound.energy_forces_at(ss.positions, box, {})[0])
    say(f"phase 18c minimize ({JAC_MIN_ITERATIONS} FIRE iterations on K2, "
        f"the cached route): U {float(u0):.1f} -> {u_min:.1f} kJ/mol in "
        f"{t_min:.2f} s")
    assert u_min < float(u0)

    for key in k.launches:
        k.launches[key] = 0
    state = bound.initial_state(ss, torch.Generator(device=dev).manual_seed(0))
    rates = []
    for _ in range(JAC_STEPS // JAC_CHUNK):
        tc = time.perf_counter()
        state = bound.run(state, JAC_CHUNK)
        positions = state.positions.cpu().numpy()
        rates.append(JAC_CHUNK / (time.perf_counter() - tc))
        assert positions.shape == (n, 3)
    launches = dict(k.launches)
    assert launches == {"sweep_bound": JAC_STEPS + 1,
                        "sweep_forces": JAC_STEPS + 1}, launches
    bound.check_sweep_overflow(state.sweep_overflow)
    assert not bool(state.sweep_overflow)
    geom = bond_error(system, state.positions, box)
    u_ref, f_ref = plain64_u_f(ref, state.positions, box)
    u_rel, f_rel = _u_f_rel(state.potentials[0], state.forces[0], u_ref,
                            f_ref)
    median = statistics.median(rates[1:])
    ns_day = median * 0.002 * 86400 / 1e3
    say(f"phase 18c main path ({STAND_IN}): {JAC_STEPS} steps of 2 fs in "
        f"{len(rates)} chunks of {JAC_CHUNK}; K2 launches {launches}; no "
        f"bitfield overflow; worst constraint error {geom:.2e}; final U "
        f"{float(state.potentials[0]):.4f} vs CPU float64 plain "
        f"{float(u_ref):.4f} (rel {u_rel:.2e}), F rel {f_rel:.2e}")
    assert geom <= 1e-5, geom
    assert u_rel <= JAC_U_REL and f_rel <= REL_TOL, (u_rel, f_rel)

    state, wall_ms, busy_ms, parts, top, _ = profile_steps(
        bound, state, 50, phase="phase 18c")
    step_ms = 1e3 / median
    say(f"phase 18c throughput ({STAND_IN}): {step_ms:.3f} ms a step, "
        f"{median:.2f} steps/s median of the chunks after the first "
        f"({[round(r, 2) for r in rates]}), {ns_day:.3f} ns/day at 2 fs; K2 "
        f"(bound + forces) device {parts['K2 sweep'][0]:.4f} ms a step, the "
        f"device busy {busy_ms:.4f} ms a step: busy share "
        f"{busy_ms / step_ms:.3f} of the unprofiled step ({smi})")
    say("phase 18c profile, device ms/step (host ms/step in the range) by "
        "part: " + "; ".join(f"{label} {dev_ms:.4f} ({host_ms:.3f})"
                             for label, (dev_ms, host_ms) in parts.items()))
    say("phase 18c profile, busiest device activities (ms/step): " +
        "; ".join(f"{name} {ms:.4f}" for name, ms in top))

    # K2's force kernel at the final state: against its plain version,
    # launched twice to the same bits, timed, and its bound from the pairs
    # it tests and evaluates (the water row's count)
    x = state.positions
    xT, par, excl, L, max_sep = tsw.sorted_inputs(term, x, box, k)
    plain = tsw.PlainSweepNonbonded.like(k)
    # the bound's int against the plain version's (a bound too small would
    # drop the same pairs from both sweeps below)
    same_bound(k, plain, *path_ring(bound, state),
               f"phase 18c the path's own ring at the final state "
               f"({STAND_IN})")
    same_bound(k, plain, xT, L,
               f"phase 18c the final state, fresh ring ({STAND_IN})")
    flag = torch.tensor(True, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    before = dict(k.launches)
    nb = k.measure_bound(xT, L, flag, zero)
    F, U = k.sweep(xT, par, excl, L, nb)
    F2, U2 = k.sweep(xT, par, excl, L, nb)
    F_ref, U_ref = plain.sweep(xT, par, excl, L, nb)
    f_err = float((F - F_ref).abs().max())
    assert torch.equal(F, F2) and torch.equal(U, U2)
    assert max_rel(F, F_ref) <= REL_TOL
    S = min(int(nb) * k.bs, k.n_pad // 2)
    t = {}
    for label, fn, reps in (
            ("plain", lambda: plain.sweep(xT, par, excl, L, nb), 5),
            ("kernel", lambda: k.sweep(xT, par, excl, L, nb), 50),
            ("kernel2", lambda: k.sweep(xT, par, excl, L, nb), 50),
            ("plain2", lambda: plain.sweep(xT, par, excl, L, nb), 5)):
        t[label] = (launch_ms(fn, "sweep_forces_f32", reps=reps)
                    if label.startswith("kernel") else cuda_ms(fn, reps=reps))
    k.launches.update(before)
    f_ms = min(t["kernel"], t["kernel2"])
    plain_ms = min(t["plain"], t["plain2"])
    tested, inside = sweep_pairs(xT, L, k, S)
    in_bytes = 4 * (3 * k.n_pad + 3 * k.n_pad + k.mask_rows * k.n_pad + 3 + 1)
    f_bound = bound_ms(in_bytes + 4 * (3 * k.n_pad + 1),
                       tested * OPS_DIST + inside * OPS_PAIR)
    say(f"phase 18c K2 sweep_forces at the final state ({STAND_IN}; bound "
        f"{int(nb)} blocks, S = {S} shells, the largest exception "
        f"separation {int(max_sep)} of mask_shells {k.mask_shells}): kernel "
        f"{f_ms:.4f} ms device, plain {plain_ms:.4f} ms, bound "
        f"{f_bound[0]:.4f} ms by {f_bound[1]} ({tested:.0f} pair tests, "
        f"{inside:.0f} pairs inside the cutoff); max|dF| {f_err:.3e} against "
        f"the plain version ({smi})")
    entry = dict(name="sweep_forces", route="cuda", source=SWEEP_SOURCE,
                 replaces=SWEEP_REPLACES, launches=launches["sweep_forces"],
                 max_abs_err=f_err, ms=f_ms, plain_ms=plain_ms,
                 bound_ms=f_bound[0], bound_by=f_bound[1], library_ms=None,
                 at=STAND_IN)
    return entry, dict(
        atoms=n, exceptions=n_exc, build_s=t_build, bind_s=t_bind,
        minimize_s=t_min, steps=JAC_STEPS, rates=rates,
        steps_per_s_median=median, step_ms=step_ms, ns_per_day=ns_day,
        k2_device_ms=parts["K2 sweep"][0], device_busy_ms=busy_ms,
        busy_share=busy_ms / step_ms, constraint_error=geom,
        initial_rel=[u_rel0, f_rel0], final_rel=[u_rel, f_rel],
        max_exception_separation=int(max_sep),
        cpu_float64_eval_s=t_ref, launches=launches)


def _run_script(module, argv, label):
    """``module.main(argv)`` with its output captured and echoed; returns
    (exit code, lines)."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    wall = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        say(f"{label}: {line}")
    say(f"{label}: exit {rc} in {wall:.1f} s")
    return rc, lines, wall


def phase_benchmarks(smi):
    """18d: benchmark_dhfr at the JAC convention (200 steps, no check: 18c
    holds that system against CPU float64) and at the reference defaults
    (1.0 nm, a 0.15 nm switch, 1e-5; 500 steps and the script's own check);
    18e: benchmark_remd cut to 16 replicas x 50 steps x 3 iterations on the
    vacuum stand-in. The data directory is the stand-in's."""
    import re

    from openmmtools_tpu_torch.scripts import benchmark_dhfr, benchmark_remd

    out = {}
    for label, args in (("jac", DHFR_JAC_ARGS),
                        ("reference", DHFR_REFERENCE_ARGS)):
        rc, lines, wall = _run_script(
            benchmark_dhfr, args,
            f"phase 18d benchmark_dhfr {' '.join(args)} ({STAND_IN})")
        assert rc == 0
        assert any("bounded sweep (K2)" in line for line in lines), lines
        checked = any("plain float64 parity" in line for line in lines)
        assert checked == ("--no-check" not in args), lines
        ms = [float(m.group(1)) for m in (
            re.search(r"([0-9.]+) ms/step", line) for line in lines) if m]
        assert len(ms) == 1, lines
        out[label] = dict(ms_step=ms[0], wall_s=wall)
    say(f"phase 18d benchmark_dhfr ({STAND_IN}): {out['jac']['ms_step']} ms "
        f"a step at the JAC convention, {out['reference']['ms_step']} ms at "
        f"the reference defaults ({smi})")
    rc, lines, wall = _run_script(benchmark_remd, REMD_CUT,
                                  f"phase 18e benchmark_remd "
                                  f"{' '.join(REMD_CUT)} (vacuum stand-in)")
    assert rc == 0 and "route batched" in lines[0], lines
    ms = [float(m.group(1)) for m in (
        re.search(r"([0-9.]+) ms/iteration", line) for line in lines) if m]
    assert len(ms) == 1, lines
    out["remd"] = dict(ms_iteration=ms[0], wall_s=wall)
    return out


def remd_step_profile(dev, smi, n_steps=20):
    """18e: ``profile_steps`` over batched steps of benchmark_remd's cut
    configuration: the replicas of its sampler as one batched state through
    the bound integrator its Langevin move uses (the generic program,
    M-SHAKE on the CH clusters, under vmap)."""
    from openmmtools_tpu_torch.mcmc import _resolve
    from openmmtools_tpu_torch.scripts import benchmark_remd

    n_rep, n_md = int(REMD_CUT[1]), int(REMD_CUT[3])
    _, sampler = benchmark_remd._build_sampler(n_rep, n_md, 1, 1, None, dev)
    states = sampler._states_on(dev)
    ts = [_resolve(states[int(s)]) for s in sampler._replica_states]
    bound = sampler._moves_per_state()[0]._bound(ts[0])
    assert not bound.sweep_mode and bound._clusters is not None
    gens = [torch.Generator(device=dev).manual_seed(i) for i in range(n_rep)]
    state = bound.initial_state_batch(list(sampler._sampler_states), gens,
                                      thermodynamic_states=ts)
    state, wall_ms, busy_ms, parts, top, aten = profile_steps(
        bound, state, n_steps, phase="phase 18e")
    assert all(bool(torch.isfinite(u).all()) for u in state.potentials)
    say(f"phase 18e a batched step of {n_rep} replicas (vacuum stand-in, "
        f"the generic program): {wall_ms:.3f} ms wall under the profiler, "
        f"{aten:.0f} ATen calls on the host, the device busy {busy_ms:.4f} "
        f"ms ({busy_ms / wall_ms:.3f} of it); device ms (host ms in the "
        f"range) by part: " + "; ".join(
            f"{label} {dev_ms:.4f} ({host_ms:.3f})"
            for label, (dev_ms, host_ms) in parts.items()) + f" ({smi})")
    return dict(wall_ms=wall_ms, aten_calls=aten, busy_ms=busy_ms,
                parts=parts)


def phase_prmtop(dev, smi):
    """Phase 18 in a temporary data directory, the loader's
    ``DEFAULT_DATA_DIR`` (and ``OPENMMTOOLS_TPU_DATA``) pointed at it."""
    import os

    from openmmtools_tpu_torch.models import amber

    t0 = time.perf_counter()
    saved = amber.DEFAULT_DATA_DIR, os.environ.get("OPENMMTOOLS_TPU_DATA")
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        amber.DEFAULT_DATA_DIR = os.environ["OPENMMTOOLS_TPU_DATA"] = tmp
        try:
            out = {"stand_ins": phase_stand_ins(root, smi)}
            native = phase_native_parser(root, smi)
            out["loader_water"] = phase_loader_water(dev, smi, root)
            entry, out["jac_path"] = phase_jac_path(dev, smi, root)
            out.update(phase_benchmarks(smi))
            out["remd"]["profile"] = remd_step_profile(dev, smi)
        finally:
            amber.DEFAULT_DATA_DIR = saved[0]
            if saved[1] is None:
                os.environ.pop("OPENMMTOOLS_TPU_DATA", None)
            else:
                os.environ["OPENMMTOOLS_TPU_DATA"] = saved[1]
    out["seconds"] = time.perf_counter() - t0
    say(f"phase 18 in {out['seconds']:.1f} s")
    return entry, out, native



# -- phase 20: the API that closes the port ---------------------------------
F10_ITERATIONS = 2         # 20b: iterations of each sampler


def phase_stacked_states(dev, smi, sampler):
    """20a: ``sampler``'s replicas (19c's, each at its own box) stacked
    and listed, each form through the batched energy route of the
    sampler's energy matrix (``energies_batch``, no global parameters):
    the same bits, one launch of each K2 kernel at B = R a form, and each
    ``index_sampler_state`` of the stack equal to its replica."""
    from openmmtools_tpu_torch.states import (
        index_sampler_state,
        stack_sampler_states,
    )

    listed = sampler.sampler_states
    r = len(listed)
    stacked = stack_sampler_states(listed)
    assert stacked.positions.shape == (r,) + tuple(listed[0].positions.shape)
    assert stacked.box_vectors.shape == (r, 3, 3)
    bound = sampler._matrix_bound()
    assert bound.sweep_mode
    k = bound._sweep_kernel
    rep = torch.arange(r, device=dev)
    forms = {"listed": (torch.stack([ss.positions for ss in listed]),
                        torch.stack([ss.box_vectors for ss in listed])),
             "stacked": (stacked.positions, stacked.box_vectors)}
    u, launches = {}, {}
    for name, (x, box) in forms.items():
        reset_counts([k])
        u[name], overflow = bound.energies_batch(x, box, rep, {})
        bound.check_sweep_overflow(overflow)
        torch.cuda.synchronize()
        launches[name] = batch_key(merged_counts([k])[1])
    indexed = [all(torch.equal(getattr(index_sampler_state(stacked, i), f),
                               getattr(ss, f))
                   for f in ("positions", "velocities", "box_vectors"))
               for i, ss in enumerate(listed)]
    same = torch.equal(u["listed"], u["stacked"])
    say(f"phase 20a {r} replicas of 19c stacked (positions "
        f"{tuple(stacked.positions.shape)}, boxes "
        f"{tuple(stacked.box_vectors.shape)}) and listed through "
        f"energies_batch: U {u['stacked'].tolist()} kJ/mol, bit-equal "
        f"{same}; K2 launches by batch size listed {launches['listed']}, "
        f"stacked {launches['stacked']}; index_sampler_state equal to each "
        f"replica {indexed} ({smi})")
    assert same
    assert all(indexed), indexed
    want = {f"sweep_bound x{r}": 1, f"{k.forces_kernel} x{r}": 1}
    assert launches["listed"] == launches["stacked"] == want, launches
    assert bool(torch.isfinite(u["stacked"]).all())
    return dict(replicas=r, energies=u["stacked"].tolist(), bit_equal=same,
                launches=launches)


def phase_integrator_move_resume(dev, smi):
    """20b: fault F10 on the card. 19c's NPT tree with an
    ``IntegratorMove`` of a ``LangevinIntegrator`` (sweep mode, K2) in the
    Langevin move's place, built directly and rebuilt through
    ``move_to_dict`` -> JSON -> ``move_from_dict`` (what the reporter
    stores, in plain values): the integrators' ``serialize`` dicts equal,
    then two samplers from one seed, ``F10_ITERATIONS`` each, with the same
    positions, boxes and energy matrix to the bit, K2's launches by batch
    size equal, and the two bound integrators' listings equal."""
    from openmmtools_tpu_torch.integrators import LangevinIntegrator
    from openmmtools_tpu_torch.mcmc import (
        IntegratorMove,
        MonteCarloBarostatMove,
        SequenceMove,
        moves_equal,
    )
    from openmmtools_tpu_torch.models import PMEWaterBox
    from openmmtools_tpu_torch.multistate.reporter import (
        move_from_dict,
        move_to_dict,
    )
    from openmmtools_tpu_torch.utils.serialization import serialize

    direct = SequenceMove([
        IntegratorMove(LangevinIntegrator(temperature=WATER_T,
                                          collision_rate=1.0, timestep=0.002,
                                          splitting="V R O R V"),
                       n_steps=PT_WATER_STEPS),
        MonteCarloBarostatMove(volume_scale=NPT_VOLUME_SCALE,
                               n_attempts=NPT_ATTEMPTS)])
    stored = json.dumps(move_to_dict(direct))
    rebuilt = move_from_dict(json.loads(stored))
    a, b = (serialize(m.move_list[0].integrator)["_state"]["items"]
            for m in (direct, rebuilt))
    differ = sorted(key for key in a.keys() | b.keys()
                    if a.get(key) != b.get(key))
    assert not differ, differ
    assert moves_equal(direct, rebuilt)
    w = PMEWaterBox(box_edge=WATER_EDGE, device=dev)
    runs = {}
    for name, moves in (("direct", direct), ("rebuilt", rebuilt)):
        sampler, t_setup = npt_pt_sampler(w, moves)
        states = sampler._thermodynamic_states
        assert sampler.propagation_route == "batched"
        bound = moves.move_list[0]._bound(states[0])
        assert bound.sweep_mode
        kernels = tree_kernels([moves.move_list[0]], states)
        reset_counts(kernels)
        t0 = time.perf_counter()
        sampler.run(F10_ITERATIONS)
        torch.cuda.synchronize()
        runs[name] = dict(sampler=sampler, setup_s=t_setup,
                          wall=time.perf_counter() - t0,
                          by_batch=merged_counts(kernels)[1],
                          listing=bound.pretty_print())
    d, r = runs["direct"]["sampler"], runs["rebuilt"]["sampler"]
    positions = [torch.equal(x.positions, y.positions)
                 for x, y in zip(d.sampler_states, r.sampler_states)]
    boxes = [torch.equal(x.box_vectors, y.box_vectors)
             for x, y in zip(d.sampler_states, r.sampler_states)]
    matrix = bool(np.array_equal(d.energies_last_iteration,
                                 r.energies_last_iteration))
    n = d.n_replicas
    say(f"phase 20b F10 on PMEWaterBox({WATER_EDGE}): 19c's tree with "
        f"IntegratorMove(LangevinIntegrator 2 fs, {PT_WATER_STEPS} steps) "
        f"stored as {len(stored)} bytes of JSON and rebuilt; {n} replicas, "
        f"{F10_ITERATIONS} iterations each: direct set-up "
        f"{runs['direct']['setup_s']:.2f} s, run {runs['direct']['wall']:.2f}"
        f" s; rebuilt set-up {runs['rebuilt']['setup_s']:.2f} s, run "
        f"{runs['rebuilt']['wall']:.2f} s; positions bit-equal {positions}, "
        f"boxes {boxes}, energy matrix {matrix}; K2 by batch size direct "
        f"{batch_key(runs['direct']['by_batch'])}, rebuilt "
        f"{batch_key(runs['rebuilt']['by_batch'])}; box edges "
        f"{[float(ss.box_vectors[0, 0]) for ss in r.sampler_states]} nm "
        f"({smi})")
    say("phase 20b the rebuilt move's bound integrator:\n"
        + runs["rebuilt"]["listing"])
    assert all(positions), positions
    assert all(boxes), boxes
    assert matrix
    assert np.array_equal(d.replica_states, r.replica_states)
    assert runs["direct"]["by_batch"] == runs["rebuilt"]["by_batch"] == \
        npt_launches(n, F10_ITERATIONS), runs["direct"]["by_batch"]
    assert runs["direct"]["listing"] == runs["rebuilt"]["listing"]
    return dict(replicas=n, iterations=F10_ITERATIONS, json_bytes=len(stored),
                setup_s=[runs[k]["setup_s"] for k in runs],
                seconds=[runs[k]["wall"] for k in runs],
                batch_launches=batch_key(runs["rebuilt"]["by_batch"]),
                bit_equal=dict(positions=positions, boxes=boxes,
                               matrix=matrix))


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
    launches14 = collections.Counter(
        re_sampler._matrix_bound()._sweep_kernel.batch_launches)
    multistate["sams"] = phase_multistate_sams(dev, smi, re_sampler)
    multistate["pt"] = phase_multistate_pt(dev, smi)
    equilibration = phase_equilibration(dev, smi)
    equilibration["pt_water"] = phase_pt_water(dev, smi)
    launches15 = equilibration["pt_water"].pop("by_batch")
    catalog = phase_catalog(dev, smi)
    t0 = time.perf_counter()
    batched_kernels, batched = phase_batched_kernels(dev, smi, re_sampler,
                                                     launches14, launches15)
    batched["eager_loop"] = phase_eager_loop(dev, smi, re_sampler)
    batched["against_eager"] = phase_batched_against_eager(dev, smi,
                                                           re_sampler)
    batched["demo"] = phase_demo(smi)
    batched["atom_shard"] = phase_atom_shard(dev, smi)
    batched["seconds"] = time.perf_counter() - t0
    say(f"phase 17 in {batched['seconds']:.1f} s")
    jac_kernel, prmtop, native = phase_prmtop(dev, smi)
    t0 = time.perf_counter()
    trees = {"ladder": phase_tree_batched(dev, smi, re_sampler,
                                          batched["eager_loop"])}
    trees["against_eager"] = phase_tree_against_eager(dev, smi, re_sampler)
    npt_sampler, trees["npt"] = phase_npt_tree(dev, smi)
    trees["per_state"] = phase_per_state_moves(dev, smi, re_sampler)
    trees["native_parser"] = native
    trees["seconds"] = time.perf_counter() - t0
    say(f"phase 19 in {trees['seconds']:.1f} s (19e within phase 18)")
    t0 = time.perf_counter()
    closing = {"stacked_states": phase_stacked_states(dev, smi, npt_sampler)}
    closing["integrator_move_resume"] = phase_integrator_move_resume(dev,
                                                                     smi)
    closing["seconds"] = time.perf_counter() - t0
    say(f"phase 20 in {closing['seconds']:.1f} s ({smi})")
    say(json.dumps({"lj_path": rate, "explicit_solvent_path": water_rate,
                    "alchemical_path": alch_rate, "ncmc_path": ncmc,
                    "alchemical_kernel_worst": k8, "dense_path": dense_rate,
                    "cell_path": cell_rate, "mcmc_path": mcmc,
                    "multistate_path": multistate,
                    "equilibration_path": equilibration,
                    "catalog_path": catalog, "batched_path": batched,
                    "prmtop_path": prmtop, "move_trees": trees,
                    "closing_api": closing,
                    "card": smi}, default=str))
    print(json.dumps({"kernels": kernels + water_kernels + [alch_kernel]
                      + [dense_kernel] + cell_kernels + batched_kernels
                      + [jac_kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
