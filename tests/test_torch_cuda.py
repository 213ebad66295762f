"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package, so it also runs on a machine that has only
PyTorch; there, skip the suite's conftest (which configures JAX):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: float32 kernel against float32 plain version, both on the card.
Sums run in another order and rsqrtf/erfcf differ from torch's in the last
bits, so both agree to float32 rounding; the bounds are the ones the JAX
package holds its TPU kernels to (2e-4 of scale; for 40-step trajectories
dx < 5e-4 modulo L and dv < 5e-3 of the velocity scale). The sweep kernels'
block bound must equal the plain version's exactly: both round r^2 the same
way.
"""
import collections

import numpy as np
import pytest
import torch

from openmmtools_tpu_torch.constants import kB
from openmmtools_tpu_torch.integrators import (
    BAOABIntegrator,
    LangevinIntegrator,
    fire_minimize,
    minimize,
)
from openmmtools_tpu_torch.models import LennardJonesFluid
from openmmtools_tpu_torch.ops.fused_langevin import (
    FusedSortedLangevin,
    fused_langevin_reference,
    lj_forces_reference,
    lj_pair_reference,
)
from openmmtools_tpu_torch.states import SamplerState

SPLITTINGS = ["V R O R V", "O V R V O", "V R R O R R V", "V R V"]
REL = 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


_CALM = {}


def _calm(n):
    """LJ fluid of N particles, FIRE-minimized on the card (once per N): the
    raw Sobol start at a ragged N has a clash (forces ~2e6 kJ/mol/nm) that
    turns float32 rounding into 0.05 nm of divergence within 40 steps."""
    if n not in _CALM:
        fluid = LennardJonesFluid(nparticles=n, device="cuda")
        x, _ = fire_minimize(fluid.system, fluid.positions,
                             fluid.system.default_box, max_steps=200)
        fluid.positions = x
        _CALM[n] = fluid
    return _CALM[n]


@pytest.fixture(scope="module")
def calm_fluid():
    """The minimized fluid of N = 1000 (a ragged size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return _calm(1000)


def _program(fluid, tokens="V R O R V", collision_rate=1.0):
    t = fluid.system.terms[0]
    return FusedSortedLangevin(
        fluid.n_particles, t.cutoff, t.switch_width, float(t.sigma[0]),
        float(t.epsilon[0]), float(fluid.system.masses[0]), 0.002,
        collision_rate, tokens=tuple(tokens.split()))


def _rel(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


def _wrapped_dx(a, b, L):
    d = (torch.remainder(a, L) - torch.remainder(b, L)).abs()
    return float(torch.minimum(d, (d - L).abs()).max())


def _thermal(n, device, seed=1):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((n, 3), device=device, generator=gen) * (
        (kB * 120.0 / 39.9) ** 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2048, 1000, 200])
@pytest.mark.parametrize("switched", [True, False])
def test_cuda_forces_match_plain(cuda, n, switched):
    """N = 1000 and 200 leave a ragged last tile."""
    fluid = LennardJonesFluid(nparticles=n, device=cuda,
                              switch_width=0.34 if switched else None)
    prog = _program(fluid)
    xT = fluid.positions.t().contiguous()
    L = torch.diagonal(fluid.system.default_box).contiguous()
    F, U = prog.forces(xT, L)
    F_ref, U_ref = lj_forces_reference(xT, L, **prog._physics())
    torch.cuda.synchronize()
    assert prog.launches["lj_forces"] == 1
    assert _rel(F, F_ref) <= REL
    assert abs(float(U[0] - U_ref)) <= REL * abs(float(U_ref))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2048, 1000, 200])
@pytest.mark.parametrize("splitting", SPLITTINGS + ["R V R V"])
def test_cuda_chunk_matches_plain_with_noise(cuda, splitting, n):
    """Same seed, same Philox stream: the chunk kernel's 40-step chunk with
    noise, one launch, matches the plain chunk ("R V R V" sweeps twice a
    step; N = 1000 and 200 leave a ragged last block)."""
    fluid = _calm(n)
    prog = _program(fluid, splitting)
    v0 = _thermal(n, cuda)
    box = fluid.system.default_box
    kT = kB * 120.0
    out = prog.chunk(fluid.positions, v0, box, kT, 1234, 40)
    ref = fused_langevin_reference(prog, fluid.positions, v0, box, kT, 1234,
                                   40)
    torch.cuda.synchronize()
    assert prog.launches == {"lj_forces": 0, "lj_chunk": 1}
    assert _wrapped_dx(out[0], ref[0], float(box[0, 0])) < 5e-4
    assert float((out[1] - ref[1]).abs().max()) < 5e-3 * float(ref[1].abs().max())
    assert abs(float(out[3] - ref[3])) <= REL * abs(float(ref[3]))
    assert _rel(out[2], ref[2]) <= 10 * REL


@pytest.mark.cuda
@pytest.mark.parametrize("splitting", ["V R O R V", "R V R V"])
def test_cuda_chunk_is_deterministic(cuda, calm_fluid, splitting):
    """Two launches on one seed give the same bits (sums in a fixed order,
    no float atomics), on both wrappers."""
    fluid = calm_fluid
    prog = _program(fluid, splitting)
    v0 = _thermal(1000, cuda)
    box = fluid.system.default_box
    a = prog.chunk(fluid.positions, v0, box, kB * 120.0, 99, 30)
    b = prog.chunk(fluid.positions, v0, box, kB * 120.0, 99, 30)
    for u, w in zip(a, b):
        assert torch.equal(u, w)
    assert prog.launches["lj_chunk"] == 2
    if splitting == "V R O R V":
        k = _dense(fluid, 1.0)
        for u, w in zip(k.chunk(fluid.positions, v0, box, kB * 120.0, 99, 30),
                        a):
            assert torch.equal(u, w)
        assert k.launches == {"dense_baoab": 1}


def _plain_forces_by_rows(xT, L, prog, rows=2048):
    """lj_forces_reference computed a block of rows at a time (its (N, N)
    matrices do not fit at N = 32,768): F (3, N) and U in float64."""
    n = xT.shape[1]
    physics = prog._physics()
    F, U = [], 0.0
    for r0 in range(0, n, rows):
        ds, r2 = [], 0.0
        for c in range(3):
            d = xT[c, r0:r0 + rows, None] - xT[c][None, :]
            d = d - L[c] * torch.round(d * (1.0 / L[c]))
            ds.append(d)
            r2 = r2 + d * d
        mask = (r2 < prog.rc ** 2) & (r2 > 1e-12)
        w, e = lj_pair_reference(r2, mask, **physics)
        F.append(torch.stack([torch.sum(w * d, dim=1) for d in ds]))
        U += float(e.double().sum())
    return torch.cat(F, dim=1), 0.5 * U


@pytest.mark.cuda
@pytest.mark.parametrize("n, steps", [(16384, 3), (32768, 0)])
def test_cuda_chunk_accepts_large_fluids(cuda, n, steps):
    """The persistent grid refuses no N up to K1's 32,768: a noisy chunk at
    N = 16,384 against the plain chunk, and F and U at N = 32,768 against
    the plain forces summed a block of rows at a time."""
    fluid = LennardJonesFluid(nparticles=n, device=cuda)
    prog = _program(fluid)
    v0 = _thermal(n, cuda)
    box = fluid.system.default_box
    out = prog.chunk(fluid.positions, v0, box, kB * 120.0, 7, steps)
    assert prog.launches == {"lj_forces": 0, "lj_chunk": 1}
    if steps:
        ref = fused_langevin_reference(prog, fluid.positions, v0, box,
                                       kB * 120.0, 7, steps)
        torch.cuda.synchronize()
        assert _wrapped_dx(out[0], ref[0], float(box[0, 0])) < 5e-4
        assert float((out[1] - ref[1]).abs().max()) < 5e-3 * float(
            ref[1].abs().max())
        F_ref, U_ref = ref[2], float(ref[3])
    else:
        L = torch.diagonal(box).contiguous()
        F_ref, U_ref = _plain_forces_by_rows(out[0].t().contiguous(), L, prog)
        F_ref = F_ref.t()
        assert torch.equal(out[1], v0)
    assert _rel(out[2], F_ref) <= REL
    assert abs(float(out[3]) - U_ref) <= REL * abs(U_ref)


@pytest.mark.cuda
def test_cuda_fused_path_matches_generic_program(cuda, calm_fluid):
    """The main path on the card: bind engages the fused kernel, and at
    collision_rate 0 it follows the generic dense program."""
    fluid = calm_fluid
    v0 = _thermal(1000, cuda)
    start = SamplerState(positions=fluid.positions, velocities=v0,
                         box_vectors=fluid.system.default_box)
    fused = BAOABIntegrator(temperature=120.0, collision_rate=0.0,
                            timestep=0.002).bind(fluid.system)
    generic = LangevinIntegrator(temperature=120.0, collision_rate=0.0,
                                 timestep=0.002, neighborlist=None
                                 ).bind(fluid.system)
    assert fused.force_path.name == "K1" and generic.force_path.name != "K1"
    a = fused.run(fused.initial_state(start, torch.Generator()), 40)
    b = generic.run(generic.initial_state(start, torch.Generator()), 40)
    # the initial state's F and U by the force kernel, the run one chunk
    assert fused.force_path.kernel.launches == {"lj_forces": 1, "lj_chunk": 1}
    assert _wrapped_dx(a.positions, b.positions, float(fluid.box_edge)) < 5e-4
    assert float((a.velocities - b.velocities).abs().max()) < \
        5e-3 * float(b.velocities.abs().max())
    assert abs(float(a.potentials[0] - b.potentials[0])) <= \
        REL * abs(float(b.potentials[0]))
    assert a.step_count == b.step_count == 40


@pytest.mark.cuda
@pytest.mark.parametrize("splitting", ["R V " * 9, "V R " + "O " * 15])
def test_cuda_long_splitting_takes_the_generic_program(cuda, splitting,
                                                        monkeypatch):
    """A splitting whose step program the chunk kernel's table cannot hold
    (19 items; 17 tokens before the sweep) binds on LJ-2048 without the
    fused kernel, as the JAX package runs it, and steps through the generic
    program: no chunk is launched."""
    def no_chunk(*args, **kwargs):
        raise AssertionError("the chunk kernel was launched")

    monkeypatch.setattr(FusedSortedLangevin, "chunk", no_chunk)
    fluid = LennardJonesFluid(nparticles=2048, device=cuda)
    bound = LangevinIntegrator(temperature=120.0, collision_rate=1.0,
                               timestep=0.002, splitting=splitting.strip()
                               ).bind(fluid.system)
    assert bound.force_path.name != "K1"
    start = SamplerState(positions=fluid.positions,
                         velocities=_thermal(2048, cuda),
                         box_vectors=fluid.system.default_box)
    first = bound.initial_state(start,
                                torch.Generator(device=cuda).manual_seed(0))
    fused = BAOABIntegrator(temperature=120.0, collision_rate=1.0,
                            timestep=0.002).bind(fluid.system)
    assert fused.force_path.name == "K1"
    u_fused = fused.initial_state(start, torch.Generator()).potentials[0]
    assert abs(float(first.potentials[0] - u_fused)) <= REL * abs(
        float(u_fused))
    state = bound.run(first, 5)
    assert state.step_count == 5
    assert torch.isfinite(state.positions).all()
    assert torch.isfinite(state.potentials[0]).all()


@pytest.mark.cuda
def test_cuda_generic_program_keeps_the_device(cuda):
    """Systems the fused kernel does not serve take the generic program on
    the card: the harmonic oscillator, with noise from a CPU generator."""
    from openmmtools_tpu_torch.models import HarmonicOscillator

    ho = HarmonicOscillator(device=cuda)
    bound = BAOABIntegrator(temperature=300.0, collision_rate=20.0,
                            timestep=0.002).bind(ho.system)
    assert bound.force_path.name != "K1"
    state = bound.initial_state(ho.sampler_state(),
                                torch.Generator().manual_seed(0))
    state = bound.run(state, 200)
    assert state.positions.device.type == "cuda"
    assert torch.isfinite(state.positions).all()
    assert float(state.potentials[0]) > 0.0


@pytest.mark.cuda
def test_cuda_wrapper_refuses_bad_kernel_inputs(cuda):
    fluid = LennardJonesFluid(nparticles=256, device=cuda)
    prog = _program(fluid)
    L = torch.diagonal(fluid.system.default_box).contiguous()
    with pytest.raises(ValueError, match="contiguous CUDA float32"):
        prog.forces(fluid.positions.double().t().contiguous(), L)
    with pytest.raises(ValueError, match="contiguous CUDA float32"):
        prog.forces(fluid.positions.t(), L)  # (3, N) view, not contiguous
    assert prog.launches["lj_forces"] == 0


# ---------------------------------------------------------------------------
# K2: the bounded-sweep kernels (csrc/sweep_nb.cu)
# ---------------------------------------------------------------------------


def _sweep_case(box_edge, method, switch_coulomb, device, cutoff=0.9):
    from openmmtools_tpu_torch.models import PMEWaterBox
    from openmmtools_tpu_torch.ops import sweep_nb as tsw

    w = PMEWaterBox(box_edge=box_edge, cutoff=cutoff, device=device)
    term = w.system.terms[0]
    n = w.system.n_particles
    n_pad = -(-n // 128) * 128
    k = tsw.SweepNonbonded(
        n, method, term.cutoff, switch_width=term.switch_width,
        ewald_alpha=term.ewald_alpha if method != "cutoff_periodic" else None,
        switch_coulomb=switch_coulomb,
        mask_shells=min(2048, max(32, (n_pad // 2 // 32) * 32)))
    xT, par, excl, L, _ = tsw.sorted_inputs(term, w.positions,
                                            w.system.default_box, k)
    return k, xT, par, excl, L


@pytest.mark.cuda
@pytest.mark.parametrize("box_edge", [1.9, 3.1])
@pytest.mark.parametrize("method,switch_coulomb", [
    ("pme", False), ("ewald", False), ("cutoff_periodic", False),
    ("pme", True)])
def test_cuda_sweep_matches_plain(cuda, box_edge, method, switch_coulomb):
    """At 1.9 nm (648 atoms) the rebuilt bound spans the whole ring, so the
    n_pad/2 shell and its half weight take part; 3.1 nm holds 3,000 atoms
    and a ragged last block of slots."""
    from openmmtools_tpu_torch.ops import sweep_nb as tsw

    k, xT, par, excl, L = _sweep_case(box_edge, method, switch_coulomb, cuda)
    bound = torch.zeros((), dtype=torch.int32, device=cuda)
    for rebuild in (True, False):
        flag = torch.tensor(rebuild, device=cuda)
        nb = k.measure_bound(xT, L, flag, bound)
        nb_ref = tsw.measure_bound_reference(
            xT, L, flag, bound, n=k.n, cutoff=k.rc, skin=k.skin,
            shell_block=k.bs)
        F, U = k.sweep(xT, par, excl, L, nb)
        F_ref, U_ref = tsw.sweep_forces_reference(xT, par, excl, L, nb_ref,
                                                  **k.physics())
        torch.cuda.synchronize()
        assert int(nb) == int(nb_ref) > 0
        assert _rel(F, F_ref) <= REL
        assert abs(float(U - U_ref)) <= REL * abs(float(U_ref))
        assert not torch.any(F[:, k.n:])
        bound = nb.reshape(()).clone()
    assert k.launches == {"sweep_bound": 2, "sweep_forces": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["pme", "cutoff_periodic"])
def test_cuda_sweep_matches_plain_at_a_long_cutoff(cuda, method):
    """rc = 1.2 nm on the 3.1 nm box (3,000 atoms): each slot queues several
    hundred pairs inside the cutoff, so its warp fills and drains the queue
    many times, across tile edges, before its last partial drain."""
    from openmmtools_tpu_torch.ops import sweep_nb as tsw

    k, xT, par, excl, L = _sweep_case(3.1, method, False, cuda, cutoff=1.2)
    flag = torch.tensor(True, device=cuda)
    zero = torch.zeros((), dtype=torch.int32, device=cuda)
    nb = k.measure_bound(xT, L, flag, zero)
    F, U = k.sweep(xT, par, excl, L, nb)
    F_ref, U_ref = tsw.PlainSweepNonbonded.like(k).sweep(xT, par, excl, L, nb)
    torch.cuda.synchronize()
    assert int(nb) == int(tsw.measure_bound_reference(
        xT, L, flag, zero, n=k.n, cutoff=k.rc, skin=k.skin,
        shell_block=k.bs)) > 0
    assert _rel(F, F_ref) <= REL
    assert abs(float(U - U_ref)) <= REL * abs(float(U_ref))
    assert not torch.any(F[:, k.n:])


@pytest.mark.cuda
@pytest.mark.parametrize("alchemical", [False, True])
def test_cuda_sweep_gives_the_same_bits_twice(cuda, alchemical):
    """Two launches on the same inputs give identical F and U: each lane
    sums its drained pairs in queue order (the ballot's), a fixed xor tree
    sums the lanes and the last block sums the energy partials in block
    order; no float atomics."""
    from openmmtools_tpu_torch.ops import sweep_nb as tsw

    lam = None
    if alchemical:
        w, system, term, k = _alchemical_case("direct-space", 1, cuda)
        xT, par, excl, L, _ = tsw.sorted_inputs(term, w.positions,
                                                system.default_box, k)
        names = term.lambda_sterics_names + term.lambda_electrostatics_names
        lam, _, _ = term.sweep_lambdas(
            {name: torch.tensor(0.5, device=cuda) for name in names}, xT)
        lam = lam.contiguous()
    else:
        k, xT, par, excl, L = _sweep_case(3.1, "pme", False, cuda)
    nb = k.measure_bound(xT, L, torch.tensor(True, device=cuda),
                         torch.zeros((), dtype=torch.int32, device=cuda))
    F1, U1 = k.sweep(xT, par, excl, L, nb, lam)
    F2, U2 = k.sweep(xT, par, excl, L, nb, lam)
    torch.cuda.synchronize()
    assert torch.equal(F1, F2) and torch.equal(U1, U2)
    assert k.launches[k.forces_kernel] == 2


@pytest.mark.cuda
def test_cuda_sweep_kernels_skip_work_without_a_rebuild(cuda):
    """Without a rebuild the bound kernel passes the given bound on, and a
    zero bound gives zero forces and energy."""
    k, xT, par, excl, L = _sweep_case(1.9, "pme", False, cuda)
    keep = torch.tensor(0, dtype=torch.int32, device=cuda)
    nb = k.measure_bound(xT, L, torch.tensor(False, device=cuda), keep)
    F, U = k.sweep(xT, par, excl, L, nb)
    torch.cuda.synchronize()
    assert int(nb) == 0 and float(U) == 0.0 and not torch.any(F)


@pytest.mark.cuda
def test_cuda_sweep_mode_engages_and_matches_plain(cuda):
    """The explicit-solvent path on the card: bind engages sweep mode with
    SETTLE on a rigid PME water box, the run goes through the kernels, and
    its final energy and forces match the plain sweep plus remainder at the
    same positions. LJ-2048 keeps the fused kernel."""
    from openmmtools_tpu_torch.models import PMEWaterBox
    from openmmtools_tpu_torch.ops import sweep_nb as tsw

    w = PMEWaterBox(box_edge=3.1, device=cuda)
    bound = BAOABIntegrator(temperature=300.0, collision_rate=1.0,
                            timestep=0.002).bind(w.system)
    assert bound.sweep_mode and bound.force_path.name != "K1"
    assert bound.constraint_solver.settle is not None
    assert bound.constraint_solver.rest is None
    state = bound.initial_state(w.sampler_state(),
                                torch.Generator(device=cuda).manual_seed(0))
    state = bound.run(state, 150)        # through one re-sort
    k = bound._sweep_kernel
    assert k.launches["sweep_forces"] == 151
    assert k.launches["sweep_bound"] == 151
    x = state.positions
    assert torch.isfinite(x).all()

    sw = bound.force_path.context(bound.force_path.refresh(state))
    bound.force_path.kernel = tsw.PlainSweepNonbonded.like(k)
    try:
        u_p, f_p, _ = bound.force_path.evaluate_sweep(
            x, state.box, state.global_params, sw)
    finally:
        bound.force_path.kernel = k
    assert abs(float(state.potentials[0] - u_p)) <= REL * abs(float(u_p))
    assert _rel(state.forces[0], f_p) <= REL

    lj = LennardJonesFluid(nparticles=2048, device=cuda)
    lj_bound = BAOABIntegrator(temperature=120.0, collision_rate=1.0,
                               timestep=0.002).bind(lj.system)
    assert lj_bound.force_path.name == "K1" and not lj_bound.sweep_mode


@pytest.mark.cuda
def test_cuda_sweep_wrapper_refuses_bad_inputs(cuda):
    k, xT, par, excl, L = _sweep_case(1.9, "pme", False, cuda)
    nb = torch.ones((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous CUDA"):
        k.sweep(xT.double(), par, excl, L, nb)
    with pytest.raises(ValueError, match="contiguous CUDA"):
        k.sweep(xT, par, excl.long(), L, nb)
    with pytest.raises(ValueError, match="contiguous CUDA"):
        k.measure_bound(xT[:, :-128], L, torch.tensor(True, device=cuda), nb)
    assert k.launches == {"sweep_bound": 0, "sweep_forces": 0}


# ---------------------------------------------------------------------------
# K2's bound kernel (csrc/sweep_nb.cu sweep_bound_kernel) on the rings the
# path rebuilds on: stale, with atoms across the x face, small, elongated,
# ragged; its int must equal the plain version's exactly
# ---------------------------------------------------------------------------


def _bound_ring(kind, device):
    """(k, xT, L) of one ring: water positions (made on the CPU, moved with
    a numpy seed) sorted by x, then, for a stale ring, moved by normal steps
    of 0.06 nm a coordinate and gathered through the old order, the atoms
    nearest the upper x face carried across it."""
    import numpy as np

    from openmmtools_tpu_torch.models import PMEWaterBox
    from openmmtools_tpu_torch.ops import sweep_nb as tsw

    edge = {"small": 1.9, "stale-6.223": 6.223, "large-staged": 12.2,
            "large": 12.5}.get(kind, 3.1)
    w = PMEWaterBox(box_edge=edge, cutoff=0.9, device="cpu")
    x = w.positions.to(torch.float64).numpy()
    box = w.system.default_box.to(torch.float64).numpy().copy()
    if kind == "elongated":
        # the box twice along y: (3.1, 6.2, 3.1) nm, 6,000 atoms
        x = np.concatenate([x, x + np.array([0.0, box[1, 1], 0.0])])
        box[1, 1] *= 2
    if kind == "ragged":
        # 2,900 atoms in 2,944 slots: a tile of 20 real slots, then one of
        # pad slots alone
        x = x[:2900]
    L = np.diagonal(box).copy()
    n = x.shape[0]
    n_pad = -(-n // 128) * 128
    perm, _ = tsw.sort_for_sweep(torch.as_tensor(x), torch.as_tensor(box),
                                 n_pad)
    rng = np.random.default_rng(5)
    if kind != "fresh":
        x = x + rng.normal(scale=0.06, size=x.shape)
        xw = x - L * np.floor(x / L)
        crossing = 300 if kind == "outliers" else 30
        x[np.argsort(-xw[:, 0])[:crossing], 0] += 0.3
    _, xT = tsw.sorted_positions(torch.as_tensor(x), torch.as_tensor(box),
                                 perm.long(), n_pad, torch.float32)
    k = tsw.SweepNonbonded(n, "pme", 0.9, ewald_alpha=3.0,
                           mask_shells=min(2048, max(32, n_pad // 64 * 32)))
    return k, xT.to(device), torch.as_tensor(L, dtype=torch.float32,
                                             device=device)


def _plain_bound(k, xT, L, flag, bound):
    from openmmtools_tpu_torch.ops import sweep_nb as tsw

    return int(tsw.measure_bound_reference(xT, L, flag, bound, n=k.n,
                                           cutoff=k.rc, skin=k.skin,
                                           shell_block=k.bs))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fresh", "stale", "stale-6.223",
                                  "outliers", "small", "elongated",
                                  "ragged", "large-staged", "large"])
def test_cuda_bound_matches_plain_on_any_ring(cuda, kind):
    """The same int as the plain version, and on a second launch, on a
    fresh ring, stale rings at 3.1 nm and at the 6.223 nm water box, a ring
    with 300 atoms across the x face, the 1.9 nm box (the bound spans the
    ring), a box elongated in y, a ragged last tile, and the two sides of
    the arcs' staging limit (47,088 bytes of shared memory, about 188,000
    slots): a stale 12.2 nm box (177,957 atoms, 44,512 bytes of arcs,
    staged; the groups outnumber the co-resident warps, so each warp takes
    several) and a stale 12.5 nm box (192,000 atoms, 48,000 bytes: every
    arc read from L2)."""
    k, xT, L = _bound_ring(kind, cuda)
    flag = torch.tensor(True, device=cuda)
    zero = torch.zeros((), dtype=torch.int32, device=cuda)
    nb = k.measure_bound(xT, L, flag, zero)
    nb2 = k.measure_bound(xT, L, flag, zero)
    ref = _plain_bound(k, xT, L, flag, zero)
    assert int(nb) == int(nb2) == ref > 0
    if kind == "small":
        assert ref == k.n_blocks
    elif kind in ("fresh", "stale-6.223", "large-staged", "large"):
        assert ref < k.n_blocks
    assert k.launches["sweep_bound"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("case,expected", [("at w", 13), ("above w", 0),
                                           ("coincident", 0)])
def test_cuda_bound_decides_the_edge_like_plain(cuda, case, expected):
    """One pair (slots 10 and 110, shell 100, block 12) among 300 atoms on
    a 3 nm lattice in a 30 nm box, in no order: at r^2 equal to w^2 in
    float32 it counts (bound 13), one ulp of x farther it does not, and a
    coincident pair (r^2 = 0) does not."""
    import numpy as np

    from openmmtools_tpu_torch.ops import sweep_nb as tsw

    rng = np.random.default_rng(9)
    sites = np.stack(np.meshgrid(*[np.arange(10)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
    sites = sites[(sites[:, 0] != 0) | (sites[:, 1] != 0) | (sites[:, 2] != 0)]
    x = 1.5 + 3.0 * sites[rng.choice(len(sites), 300, replace=False)]
    x = x.astype(np.float32)
    a = np.float32(0.5)
    d = np.float32(1.1)          # float32 (1.1)^2 rounds to float32 1.21
    b = {"at w": a + d, "above w": np.nextafter(a + d, np.float32(2)),
         "coincident": a}[case]
    x[10] = (a, 1.5, 1.5)
    x[110] = (b, 1.5, 1.5)
    xT = torch.full((3, 384), 1e6, dtype=torch.float32)
    xT[:, :300] = torch.as_tensor(x.T.copy())
    xT = xT.to(cuda)
    L = torch.full((3,), 30.0, dtype=torch.float32, device=cuda)
    k = tsw.SweepNonbonded(300, "cutoff_periodic", 1.0, skin=0.1,
                           mask_shells=32)
    _, r2 = tsw._pair_r2(xT, L, torch.tensor([10], device=cuda),
                         torch.tensor([110], device=cuda))
    w2 = torch.tensor(1.1 ** 2, dtype=torch.float32)
    assert (float(r2) == float(w2)) == (case == "at w")
    flag = torch.tensor(True, device=cuda)
    zero = torch.zeros((), dtype=torch.int32, device=cuda)
    nb = k.measure_bound(xT, L, flag, zero)
    assert int(nb) == _plain_bound(k, xT, L, flag, zero) == expected


@pytest.mark.cuda
def test_cuda_bound_rearms_its_scratch(cuda):
    """Three rebuilds in a row, the second on a ring with a lower bound:
    each gives the plain version's int, so the best block and the ticket
    were re-armed after each launch."""
    k, fresh, L = _bound_ring("fresh", cuda)
    _, stale, _ = _bound_ring("stale", cuda)
    flag = torch.tensor(True, device=cuda)
    zero = torch.zeros((), dtype=torch.int32, device=cuda)
    got = [int(k.measure_bound(xT, L, flag, zero))
           for xT in (stale, fresh, stale)]
    want = [_plain_bound(k, xT, L, flag, zero) for xT in (stale, fresh, stale)]
    assert got == want and want[1] < want[0]
    assert k.launches["sweep_bound"] == 3


@pytest.mark.cuda
def test_cuda_bound_is_one_launch_a_call(cuda):
    """With and without a rebuild a call launches the bound kernel once and
    nothing else on the device; without one it passes the bound on."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    k, xT, L = _bound_ring("stale", cuda)
    zero = torch.zeros((), dtype=torch.int32, device=cuda)
    keep = torch.tensor(17, dtype=torch.int32, device=cuda)
    on, off = (torch.tensor(v, device=cuda) for v in (True, False))
    k.measure_bound(xT, L, on, zero)   # the scratch is made on first use
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        nb_on = k.measure_bound(xT, L, on, zero)
        nb_off = k.measure_bound(xT, L, off, keep)
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    assert len(names) == 2 and all("sweep_bound_kernel" in s for s in names)
    assert int(nb_on) == _plain_bound(k, xT, L, on, zero)
    assert int(nb_off) == 17


# ---------------------------------------------------------------------------
# K2's alchemical variant (csrc/sweep_nb.cu sweep_forces_alch_f32)
# ---------------------------------------------------------------------------


def _alchemical_case(treatment, regions, device):
    """A 3.1 nm alchemical water box (3,000 atoms) made by the factory, its
    alchemical term and the kernel for it."""
    from openmmtools_tpu_torch.alchemy import (
        AbsoluteAlchemicalFactory,
        AlchemicalRegion,
    )
    from openmmtools_tpu_torch.models import PMEWaterBox
    from openmmtools_tpu_torch.ops import sweep_nb as tsw

    w = PMEWaterBox(box_edge=3.1, cutoff=0.9, device=device)
    if regions == 1:
        reg, inter = AlchemicalRegion(alchemical_atoms=[0, 1, 2]), ()
    else:
        reg = [AlchemicalRegion(alchemical_atoms=[0, 1, 2], name="a",
                                annihilate_sterics=True),
               AlchemicalRegion(alchemical_atoms=[3, 4, 5], name="b",
                                annihilate_electrostatics=False)]
        inter = {("a", "b")} if regions == "interacting" else ()
    system = AbsoluteAlchemicalFactory(
        alchemical_pme_treatment=treatment).create_alchemical_system(
        w.system, reg, frozenset(inter))
    term = system.terms[0]
    n = system.n_particles
    n_pad = -(-n // 128) * 128
    k = tsw.SweepNonbonded(
        n, term.method, term.cutoff, switch_width=term.switch_width,
        ewald_alpha=term.ewald_alpha,
        mask_shells=min(2048, max(32, (n_pad // 2 // 32) * 32)),
        n_regions=term.n_regions,
        coulomb_pme_treatment=term.coulomb_pme_treatment)
    return w, system, term, k


@pytest.mark.cuda
@pytest.mark.parametrize("treatment,regions,lam", [
    ("direct-space", 1, 1.0), ("direct-space", 1, 0.5),
    ("direct-space", 1, 0.0), ("exact", 1, 0.55), ("coulomb", 1, 0.55),
    ("direct-space", "interacting", 0.55), ("direct-space", "apart", 0.55)])
def test_cuda_alchemical_sweep_matches_plain(cuda, treatment, regions, lam):
    """The alchemical kernel against its plain version with the class
    scalars the term computes on the card, across the treatments, lambdas
    and region counts of chip_smoke.py's phase 8."""
    from openmmtools_tpu_torch.ops import sweep_nb as tsw

    w, system, term, k = _alchemical_case(treatment, regions, cuda)
    names = list(term.lambda_sterics_names + term.lambda_electrostatics_names)
    params = {name: torch.tensor(lam if name.endswith(("s", "_a")) else 0.3,
                                 device=cuda) for name in names}
    xT, par, excl, L, _ = tsw.sorted_inputs(term, w.positions,
                                            system.default_box, k)
    lam_t, _, scale = term.sweep_lambdas(params, xT)
    if scale is not None:
        par = tsw.scale_charges_by_code(par, scale)
    plain = tsw.PlainSweepNonbonded.like(k)
    flag = torch.tensor(True, device=cuda)
    zero = torch.zeros((), dtype=torch.int32, device=cuda)
    nb = k.measure_bound(xT, L, flag, zero)
    F, U = k.sweep(xT, par, excl, L, nb, lam_t.contiguous())
    F_ref, U_ref = plain.sweep(xT, par, excl, L,
                               plain.measure_bound(xT, L, flag, zero), lam_t)
    torch.cuda.synchronize()
    assert int(nb) == int(plain.measure_bound(xT, L, flag, zero)) > 0
    assert _rel(F, F_ref) <= REL
    assert abs(float(U - U_ref)) <= REL * abs(float(U_ref))
    assert not torch.any(F[:, k.n:])
    assert k.launches == {"sweep_bound": 1, "sweep_forces_alch": 1}


@pytest.mark.cuda
def test_cuda_alchemical_sweep_refuses_missing_scalars(cuda):
    from openmmtools_tpu_torch.ops import sweep_nb as tsw

    w, system, term, k = _alchemical_case("direct-space", 1, cuda)
    xT, par, excl, L, _ = tsw.sorted_inputs(term, w.positions,
                                            system.default_box, k)
    nb = torch.ones((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="class scalars"):
        k.sweep(xT, par, excl, L, nb)
    with pytest.raises(ValueError, match="contiguous CUDA"):
        k.sweep(xT, par[:3].contiguous(), excl, L, nb,
                torch.ones(6, device=cuda))
    with pytest.raises(ValueError, match="contiguous CUDA"):
        k.sweep(xT, par, excl, L, nb, torch.ones(5, device=cuda))
    assert k.launches == {"sweep_bound": 0, "sweep_forces_alch": 0}


@pytest.mark.cuda
def test_cuda_alchemical_path_engages_the_kernel(cuda):
    """Path A on the card: AlchemicalWaterBox -> compound state -> bind
    (sweep mode with the alchemical kernel) -> run through one re-sort; the
    kernel launched once a step plus once for initial_state, and the final
    energy and forces match the plain sweep plus remainder."""
    from openmmtools_tpu_torch.alchemy import AlchemicalState
    from openmmtools_tpu_torch.models import AlchemicalWaterBox
    from openmmtools_tpu_torch.ops import sweep_nb as tsw
    from openmmtools_tpu_torch.states import (
        CompoundThermodynamicState,
        ThermodynamicState,
    )

    w = AlchemicalWaterBox(box_edge=3.1, device=cuda)
    compound = CompoundThermodynamicState(
        base_state=ThermodynamicState(system=w.system, temperature=300.0),
        composable_states=(AlchemicalState(lambda_electrostatics=0.0,
                                           lambda_sterics=0.5),))
    bound = BAOABIntegrator(temperature=300.0, collision_rate=1.0,
                            timestep=0.002).bind(w.system)
    assert bound.sweep_mode and bound.force_path.alch is not None
    assert bound.force_path.name != "K1"
    k = bound._sweep_kernel
    state = bound.initial_state(w.sampler_state(),
                                torch.Generator(device=cuda).manual_seed(0),
                                thermodynamic_state=compound)
    state = bound.run(state, 150)
    assert k.launches == {"sweep_bound": 151, "sweep_forces_alch": 151}
    x = state.positions
    assert torch.isfinite(x).all()
    sw = bound.force_path.context(bound.force_path.refresh(state))
    bound.force_path.kernel = tsw.PlainSweepNonbonded.like(k)
    try:
        u_p, f_p, _ = bound.force_path.evaluate_sweep(
            x, state.box, state.global_params, sw)
    finally:
        bound.force_path.kernel = k
    assert abs(float(state.potentials[0] - u_p)) <= REL * abs(float(u_p))
    assert _rel(state.forces[0], f_p) <= REL


# ---------------------------------------------------------------------------
# K3: the dense BAOAB chunk (FusedDenseBAOAB: csrc/dense_baoab.cu's chunk
# kernel with the tokens "V R O R V")
# ---------------------------------------------------------------------------


def _dense(fluid, collision_rate, n=None):
    from openmmtools_tpu_torch.ops.fused_langevin import FusedDenseBAOAB

    t = fluid.system.terms[0]
    return FusedDenseBAOAB(
        n or fluid.n_particles, t.cutoff, t.switch_width, float(t.sigma[0]),
        float(t.epsilon[0]), float(fluid.system.masses[0]), 0.002,
        collision_rate, device=fluid.positions.device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2048, 1000, 200])
def test_cuda_dense_baoab_forces_match_plain(cuda, n):
    """n_steps = 0: F and U of the wrapped start (N = 1000 and 200 leave a
    ragged last block)."""
    fluid = LennardJonesFluid(nparticles=n, device=cuda)
    k = _dense(fluid, 1.0)
    v0 = _thermal(n, cuda)
    box = fluid.system.default_box
    out = k.chunk(fluid.positions, v0, box, kB * 120.0, 5, 0)
    ref = fused_langevin_reference(k.program, fluid.positions, v0, box,
                                   kB * 120.0, 5, 0)
    torch.cuda.synchronize()
    assert k.launches == {"dense_baoab": 1}
    assert _wrapped_dx(out[0], ref[0], float(box[0, 0])) <= 1e-5
    assert float(out[0].min()) >= 0.0 and torch.equal(out[1], ref[1])
    assert _rel(out[2], ref[2]) <= REL
    assert abs(float(out[3] - ref[3])) <= REL * abs(float(ref[3]))


@pytest.mark.cuda
@pytest.mark.parametrize("gamma", [0.0, 1.0])
def test_cuda_dense_baoab_chunk_matches_plain(cuda, calm_fluid, gamma):
    """One launch for a 40-step chunk; with noise on, the same Philox
    stream as the plain chunk."""
    fluid = calm_fluid
    k = _dense(fluid, gamma)
    v0 = _thermal(1000, cuda)
    box = fluid.system.default_box
    out = k.chunk(fluid.positions, v0, box, kB * 120.0, 2**62 + 77, 40)
    ref = fused_langevin_reference(k.program, fluid.positions, v0, box,
                                   kB * 120.0, 2**62 + 77, 40)
    torch.cuda.synchronize()
    assert k.launches == {"dense_baoab": 1}
    assert _wrapped_dx(out[0], ref[0], float(box[0, 0])) < 5e-4
    assert float((out[1] - ref[1]).abs().max()) < 5e-3 * float(ref[1].abs().max())
    assert _rel(out[2], ref[2]) <= 10 * REL
    assert abs(float(out[3] - ref[3])) <= REL * abs(float(ref[3]))


# ---------------------------------------------------------------------------
# K4: the cell-grid forces and chunk (csrc/cell_md.cu)
# ---------------------------------------------------------------------------


def _cell_program(fluid, collision_rate=1.0, **kw):
    from openmmtools_tpu_torch.ops import fused_md as tmd

    t = fluid.system.terms[0]
    spec = tmd.make_grid_spec(
        fluid.n_particles, fluid.box_edge, t.cutoff, t.switch_width,
        float(t.sigma[0]), float(t.epsilon[0]), float(fluid.system.masses[0]),
        0.002, collision_rate)
    return tmd.FusedLJBAOAB(spec, fluid.n_particles, temperature=120.0,
                            device=fluid.positions.device, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2048, 1000, 16384])
def test_cuda_cell_forces_match_plain_and_dense(cuda, n):
    from openmmtools_tpu_torch.ops import fused_md as tmd

    fluid = LennardJonesFluid(nparticles=n, device=cuda)
    k = _cell_program(fluid)
    x = fluid.positions
    xs, vs, valid, sp, mo = k.bin(x, torch.zeros_like(x))
    F = k.forces(xs, valid, rows=mo)
    F_ref = tmd.cell_forces_reference(xs, valid, k.spec)
    torch.cuda.synchronize()
    assert k.launches["cell_forces"] == 1
    assert _rel(F, F_ref) <= REL
    assert not torch.any(F * (1.0 - valid))
    Fp, _ = tmd.unbin_particles(F, F, sp, n)
    xw, _ = tmd.unbin_particles(xs, xs, sp, n)
    L = torch.full((3,), k.spec.box_edge, device=cuda)
    F_dense, _ = lj_forces_reference(xw.t().contiguous(), L,
                                     cutoff=k.spec.cutoff,
                                     switch_width=k.spec.switch_width,
                                     sigma=k.spec.sigma,
                                     epsilon=k.spec.epsilon)
    assert _rel(Fp, F_dense.t()) <= REL


@pytest.mark.cuda
def test_cuda_cell_run_matches_plain_with_noise(cuda, calm_fluid):
    """40 steps with a rebin after 20: the kernels' run and the plain run
    on the same seeds."""
    from openmmtools_tpu_torch.ops import fused_md as tmd

    fluid = calm_fluid
    v0 = _thermal(1000, cuda)
    k = _cell_program(fluid, rebuild_interval=20)
    p = _cell_program(fluid, rebuild_interval=20)
    xa, va = k.run(fluid.positions, v0, kB * 120.0,
                   torch.Generator().manual_seed(4), 40)
    xb, vb = tmd.fused_lj_reference(p, fluid.positions, v0, kB * 120.0,
                                    torch.Generator().manual_seed(4), 40)
    torch.cuda.synchronize()
    assert k.launches == {"cell_forces": 2, "cell_chunk": 2}
    assert p.launches == {"cell_forces": 0, "cell_chunk": 0}
    assert _wrapped_dx(xa, xb, float(fluid.box_edge)) < 5e-4
    assert float((va - vb).abs().max()) < 5e-3 * float(vb.abs().max())


@pytest.mark.cuda
def test_cuda_cell_run_matches_dense_baoab_at_gamma_0(cuda, calm_fluid):
    """gamma = 0, 100 steps with a rebin every 25: K4's kernels follow K3's
    all-pairs chunk."""
    fluid = calm_fluid
    v0 = _thermal(1000, cuda)
    k = _cell_program(fluid, collision_rate=0.0, rebuild_interval=25)
    xa, va = k.run(fluid.positions, v0, kB * 120.0, torch.Generator(), 100)
    xb, vb, _, _ = _dense(fluid, 0.0).run(fluid.positions, v0,
                                          fluid.system.default_box,
                                          kB * 120.0, torch.Generator(), 100)
    torch.cuda.synchronize()
    assert k.launches == {"cell_forces": 4, "cell_chunk": 4}
    assert _wrapped_dx(xa, xb, float(fluid.box_edge)) < 5e-4
    assert float((va - vb).abs().max()) < 5e-3 * float(vb.abs().max())


@pytest.mark.cuda
def test_cuda_cell_wrapper_refuses_bad_inputs(cuda):
    fluid = LennardJonesFluid(nparticles=2048, device=cuda)
    k = _cell_program(fluid)
    x = fluid.positions
    xs, vs, valid, _, _ = k.bin(x, torch.zeros_like(x))
    with pytest.raises(ValueError, match="contiguous CUDA"):
        k.forces(xs.double(), valid)
    with pytest.raises(ValueError, match="contiguous CUDA"):
        k.forces(xs[:, :8].contiguous(), valid)
    kT = torch.tensor([1.0], device=cuda)
    with pytest.raises(ValueError, match="contiguous CUDA"):
        k.chunk(xs, vs, valid.bool(), kT, 1, 1)
    assert k.launches == {"cell_forces": 0, "cell_chunk": 0}


@pytest.mark.cuda
def test_cuda_cell_kernels_past_capacity_16(cuda):
    """A droplet-like start (the fluid squeezed into one octant of its box,
    then FIRE-minimized) bins past the start's capacity of 16, as the
    condensing LJ-2048 fluid does: forces and a noisy 40-step chunk at those
    strides and rows against the plain versions."""
    from openmmtools_tpu_torch.ops import fused_md as tmd

    fluid = LennardJonesFluid(nparticles=2048, device=cuda)
    x, _ = fire_minimize(fluid.system, 0.5 * fluid.positions,
                         fluid.system.default_box, max_steps=200)
    k = _cell_program(fluid)
    xs, vs, valid, _, mo = k.bin(x, _thermal(2048, cuda))
    assert k.capacity_bumps > 0 and mo > 16
    F = k.forces(xs, valid, rows=mo)
    assert _rel(F, tmd.cell_forces_reference(xs, valid, k.spec, mo)) <= REL
    kT = torch.tensor([kB * 120.0], device=cuda)
    xa, va = k.chunk(xs.clone(), vs.clone(), valid, kT, 9, 40, rows=mo)
    xb, vb = tmd.cell_chunk_reference(xs, vs, valid, kT, 9, 40, k.spec, mo)
    torch.cuda.synchronize()
    assert k.launches == {"cell_forces": 2, "cell_chunk": 1}
    occupied = valid[None] > 0
    assert float(((xa - xb) * occupied).abs().max()) < 5e-4
    assert float(((va - vb) * occupied).abs().max()) < 5e-3 * float(
        vb.abs().max())


def _cell_kernels_match_plain(k, xs, vs, valid, mo, seed, steps=40):
    """K4's forces (nothing written to an empty slot) and a noisy chunk of
    ``steps`` on the bin (xs, vs, valid) of ``k`` at rows ``mo`` against the
    plain versions."""
    from openmmtools_tpu_torch.ops import fused_md as tmd

    F = k.forces(xs, valid, rows=mo)
    assert _rel(F, tmd.cell_forces_reference(xs, valid, k.spec, mo)) <= REL
    assert not torch.any(F * (1.0 - valid))
    kT = torch.tensor([kB * 120.0], device=xs.device)
    xa, va = k.chunk(xs.clone(), vs.clone(), valid, kT, seed, steps, rows=mo)
    xb, vb = tmd.cell_chunk_reference(xs, vs, valid, kT, seed, steps, k.spec,
                                      mo)
    torch.cuda.synchronize()
    occupied = valid[None] > 0
    assert float(((xa - xb) * occupied).abs().max()) < 5e-4
    assert float(((va - vb) * occupied).abs().max()) < 5e-3 * float(
        vb.abs().max())
    assert torch.equal(xa * ~occupied, xs * ~occupied)
    assert not torch.any(va * ~occupied)


@pytest.mark.cuda
def test_cuda_cell_kernels_past_occupancy_32(cuda):
    """A simple cubic lattice of spacing 0.37 nm (about the LJ minimum,
    jittered by 0.01 nm) bins about 64 particles into a cell, more than a
    warp's lanes, with no clash: forces and a noisy 40-step chunk against
    the plain versions. (A fluid squeezed further than 0.5 of its box keeps
    clashes through FIRE, and the plain chunk then overflows.)"""
    fluid = LennardJonesFluid(nparticles=2048, device=cuda)
    side = 13   # 13^3 >= 2048 lattice sites
    i = torch.arange(2048, device=cuda)
    sites = torch.stack([i % side, (i // side) % side, i // side ** 2], 1)
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = 0.5 + 0.37 * sites.float() + 0.01 * torch.randn(
        (2048, 3), device=cuda, generator=gen)
    k = _cell_program(fluid)
    xs, vs, valid, _, mo = k.bin(x, _thermal(2048, cuda))
    assert mo > 32 and k.spec.capacity >= mo
    _cell_kernels_match_plain(k, xs, vs, valid, mo, seed=11)
    assert k.launches == {"cell_forces": 2, "cell_chunk": 1}


@pytest.mark.cuda
def test_cuda_cell_kernels_at_n_side_3(cuda):
    """The smallest grid, LennardJonesFluid(nparticles=100): three cells a
    side, so every cell's neighbourhood wraps on both sides of each axis.
    Forces against the plain version and the dense sum, and a noisy 40-step
    chunk against the plain chunk, from a FIRE-minimized start."""
    from openmmtools_tpu_torch.ops import fused_md as tmd

    fluid = LennardJonesFluid(nparticles=100, device=cuda)
    x, _ = fire_minimize(fluid.system, fluid.positions,
                         fluid.system.default_box, max_steps=200)
    k = _cell_program(fluid)
    assert k.spec.n_side == 3 and k.spec.g_cells == 125
    xs, vs, valid, sp, mo = k.bin(x, _thermal(100, cuda))
    _cell_kernels_match_plain(k, xs, vs, valid, mo, seed=12)
    F = k.forces(xs, valid, rows=mo)
    Fp, _ = tmd.unbin_particles(F, F, sp, 100)
    xw, _ = tmd.unbin_particles(xs, xs, sp, 100)
    L = torch.full((3,), k.spec.box_edge, device=cuda)
    F_dense, _ = lj_forces_reference(xw.t().contiguous(), L,
                                     cutoff=k.spec.cutoff,
                                     switch_width=k.spec.switch_width,
                                     sigma=k.spec.sigma,
                                     epsilon=k.spec.epsilon)
    assert _rel(Fp, F_dense.t()) <= REL


@pytest.mark.cuda
def test_cuda_cell_kernels_give_the_same_bits_twice(cuda, calm_fluid):
    """No float atomics and a fixed summation order: the forces and a noisy
    175-step chunk, each launched twice on the same inputs, to the same
    bits."""
    fluid = calm_fluid
    k = _cell_program(fluid)
    x = fluid.positions
    xs, vs, valid, _, mo = k.bin(x, _thermal(1000, cuda))
    F1 = k.forces(xs, valid, rows=mo)
    F2 = k.forces(xs, valid, rows=mo)
    assert torch.equal(F1, F2)
    kT = torch.tensor([kB * 120.0], device=cuda)
    a = k.chunk(xs.clone(), vs.clone(), valid, kT, 13, 175, rows=mo)
    b = k.chunk(xs.clone(), vs.clone(), valid, kT, 13, 175, rows=mo)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert k.launches == {"cell_forces": 4, "cell_chunk": 2}


@pytest.mark.cuda
def test_cuda_cell_chunk_strides_past_the_coresident_blocks(cuda):
    """N = 16,384: 4,913 interior cells, more than the chunk kernel's
    co-resident blocks, so each block takes several cells in turn. A noisy
    3-step chunk against the plain chunk."""
    fluid = LennardJonesFluid(nparticles=16384, device=cuda)
    k = _cell_program(fluid)
    assert k.spec.n_side ** 3 == 4913
    x = fluid.positions
    xs, vs, valid, _, mo = k.bin(x, _thermal(16384, cuda))
    _cell_kernels_match_plain(k, xs, vs, valid, mo, seed=14, steps=3)


# ---------------------------------------------------------------------------
# the MCMC layer on the card: moves reach K1 and K2, the extras keep their
# own step
# ---------------------------------------------------------------------------


class _chunk_launches:
    """Counts the launches of K1's chunk kernel (its C entry point) inside
    the block, whatever wrapper makes them."""

    def __enter__(self):
        from openmmtools_tpu_torch.ops import _build

        self.lib = _build.load_library()
        self.launch = self.lib.lj_chunk_f32
        self.count = 0

        def counted(*args):
            self.count += 1
            return self.launch(*args)

        self.lib.lj_chunk_f32 = counted
        return self

    def __exit__(self, *exc):
        self.lib.lj_chunk_f32 = self.launch


@pytest.mark.cuda
@pytest.mark.parametrize("name", [
    "AndersenVelocityVerletIntegrator", "HMCIntegrator",
    "MetropolisMonteCarloIntegrator",
    "NoseHooverChainVelocityVerletIntegrator"])
def test_cuda_extras_keep_their_own_step(cuda, name):
    """On LJ-2048, where BAOAB takes K1's chunk kernel, each integrator of
    integrators/extras.py keeps its own step: no fused path, no sweep mode,
    no chunk launch, and its own counters move."""
    from openmmtools_tpu_torch import integrators as tint

    fluid = LennardJonesFluid(nparticles=2048, device=cuda)
    assert BAOABIntegrator(temperature=120.0).bind(
        fluid.system).force_path.name == "K1"
    kwargs = dict(temperature=120.0)
    if name == "MetropolisMonteCarloIntegrator":
        kwargs["displacement_sigma"] = 1e-5
    bound = getattr(tint, name)(**kwargs).bind(fluid.system)
    assert bound.force_path.name != "K1" and not bound.sweep_mode
    with _chunk_launches() as k1:
        state = bound.initial_state(fluid.sampler_state(),
                                    torch.Generator(device=cuda).manual_seed(0))
        state = bound.run(state, 5)
        torch.cuda.synchronize()
    assert k1.count == 0
    assert state.step_count == 5 and torch.isfinite(state.positions).all()
    if name in ("HMCIntegrator", "MetropolisMonteCarloIntegrator"):
        assert int(state.n_proposed) == 5


@pytest.mark.cuda
def test_cuda_langevin_move_launches_k1(cuda):
    from openmmtools_tpu_torch.mcmc import LangevinDynamicsMove

    fluid = LennardJonesFluid(nparticles=2048, device=cuda)
    ts = fluid.thermodynamic_state(120.0)
    move = LangevinDynamicsMove(timestep=0.002, collision_rate=1.0,
                                n_steps=500)
    fused = move._bound(ts).force_path.kernel
    assert fused is not None
    ss = fluid.sampler_state()
    for _ in range(2):
        ss = move.apply(ts, ss)
    assert fused.launches == {"lj_forces": 2, "lj_chunk": 2}
    assert torch.isfinite(ss.positions).all()


@pytest.mark.cuda
def test_cuda_ghmc_move_launches_k2(cuda):
    from openmmtools_tpu_torch.mcmc import GHMCMove

    fluid = LennardJonesFluid(nparticles=2048, device=cuda)
    ts = fluid.thermodynamic_state(120.0)
    move = GHMCMove(timestep=0.001, n_steps=20)
    bound = move._bound(ts)
    assert bound.sweep_mode and bound.force_path.name != "K1"
    with _chunk_launches() as k1:
        ss = move.apply(ts, fluid.sampler_state())
    assert k1.count == 0
    k = bound._sweep_kernel.launches
    assert k["sweep_bound"] > 0 and k["sweep_forces"] > 0
    assert move.n_proposed == 20 and move.n_accepted > 0
    assert torch.isfinite(ss.positions).all()


@pytest.mark.cuda
def test_cuda_barostat_box_reaches_k1_and_k2(cuda):
    """After a barostat acceptance the Langevin move (K1) and the GHMC
    move (sweep mode, K2) evaluate at the new box: each final U equals the
    dense sum at that box to 2e-4."""
    from openmmtools_tpu_torch.mcmc import (
        GHMCMove,
        LangevinDynamicsMove,
        MonteCarloBarostatMove,
    )

    fluid = LennardJonesFluid(nparticles=2048, device=cuda)
    ts = fluid.thermodynamic_state(120.0, pressure=21.0)
    baro = MonteCarloBarostatMove(volume_scale=0.02, n_attempts=10, seed=2)
    ss = baro.apply(ts, fluid.sampler_state())
    assert baro.n_accepted > 0
    edge = float(ss.box_vectors[0, 0])
    assert edge != float(fluid.system.default_box[0, 0])
    for move in (LangevinDynamicsMove(timestep=0.002, collision_rate=1.0,
                                      n_steps=200),
                 GHMCMove(timestep=0.001, n_steps=20)):
        last = {}
        hook = move._on_integration_end

        def keep(state, _hook=hook):
            last["state"] = state
            _hook(state)

        move._on_integration_end = keep
        ss = move.apply(ts, ss)
        state = last["state"]
        assert float(state.box[0, 0]) == edge
        u_dense = float(ts.potential_energy(ss))
        assert abs(float(state.potentials[0]) - u_dense) <= REL * abs(u_dense)


# -- the multistate layer -------------------------------------------------------

ALCH_LADDER = {"lambda_electrostatics": [1.0, 0.5, 0.0],
               "lambda_sterics": [1.0, 1.0, 0.5]}


def _alchemical_ladder(edge, dev):
    from openmmtools_tpu_torch.models import AlchemicalWaterBox
    from openmmtools_tpu_torch.states import (
        ThermodynamicState,
        create_thermodynamic_state_protocol,
    )

    w = AlchemicalWaterBox(box_edge=edge, device=dev)
    ref = ThermodynamicState(system=w.system, temperature=300.0,
                             global_params={"lambda_electrostatics": 1.0,
                                            "lambda_sterics": 1.0})
    return w, create_thermodynamic_state_protocol(ref, ALCH_LADDER)


@pytest.mark.cuda
def test_cuda_energies_at_matches_plain_sweep(cuda):
    """``energies_at`` on the 24,000-atom alchemical water box: one sort,
    K2 at three lambda sets as one batch (one bound and one force launch
    for the three), against the plain sweep plus the remainder; with sweep
    mode off it raises instead of taking the dense sum."""
    from openmmtools_tpu_torch.integrators.langevin import IntegratorError
    from openmmtools_tpu_torch.ops import sweep_nb as tsw

    w, states = _alchemical_ladder(6.223, cuda)
    bound = BAOABIntegrator(temperature=300.0).bind(w.system)
    assert bound.sweep_mode and bound.force_path.alch is not None
    k = bound._sweep_kernel
    x, box = w.positions, w.system.default_box
    sets = [s.global_params for s in states]
    for key in k.launches:
        k.launches[key] = 0
    got = bound.energies_at(x, box, sets)
    torch.cuda.synchronize()
    assert k.launches == {"sweep_bound": 1, "sweep_forces_alch": 1}
    bound.force_path.kernel = tsw.PlainSweepNonbonded.like(k)
    try:
        want = bound.energies_at(x, box, sets)
    finally:
        bound.force_path.kernel = k
    assert got.dtype == torch.float64
    assert float(((got - want).abs() / want.abs()).max()) <= REL
    dense = BAOABIntegrator(temperature=300.0, sweep=None).bind(w.system)
    with pytest.raises(IntegratorError, match="dense"):
        dense.energies_at(x, box, sets)


@pytest.mark.cuda
def test_cuda_replica_exchange_iteration_counts_k2(cuda):
    """One replica-exchange iteration on a 3,000-atom alchemical water box:
    the replicas' moves (5 steps, sweep mode) as one batch and the 3 x 3
    matrix as one batch launch K2's two kernels 5 + 1 + 1 times each; the
    mixing and the matrix live on the host while the replicas live on the
    card."""
    from openmmtools_tpu_torch.mcmc import LangevinSplittingDynamicsMove
    from openmmtools_tpu_torch.multistate import ReplicaExchangeSampler
    import openmmtools_tpu_torch.multistate.replicaexchange as re_module

    w, states = _alchemical_ladder(3.0, cuda)
    move = LangevinSplittingDynamicsMove(timestep=0.002, collision_rate=1.0,
                                         n_steps=5)
    bound = move._bound(states[0])
    assert bound.sweep_mode and bound.constraint_solver.settle is not None
    k = bound._sweep_kernel
    sampler = ReplicaExchangeSampler(mcmc_moves=move, number_of_iterations=1,
                                     online_analysis_interval=None)
    sampler.create(states, w.sampler_state())
    seen = []
    mix = re_module.mix_all

    def recording_mix(states_, u, *rest):
        seen.append((states_.device.type, u.device.type))
        return mix(states_, u, *rest)

    re_module.mix_all = recording_mix
    try:
        for key in k.launches:
            k.launches[key] = 0
        sampler.run()
    finally:
        re_module.mix_all = mix
    assert sampler.propagation_route == "batched"
    assert k.launches == {"sweep_bound": 7, "sweep_forces_alch": 7}
    assert seen == [("cpu", "cpu")]
    assert sampler._energies.device.type == "cpu"
    assert all(ss.positions.device.type == "cuda"
               for ss in sampler.sampler_states)
    assert torch.isfinite(sampler._energies).all()


@pytest.mark.cuda
def test_cuda_parallel_tempering_launches_k1(cuda):
    """Parallel tempering on LJ-2048: the batched route's bound integrator
    (state 0's) takes K1's fused path one replica at a time, one force and
    one chunk launch a replica an iteration; the O(N) matrix equals each
    state's dense reduced potential."""
    from openmmtools_tpu_torch.mcmc import LangevinDynamicsMove
    from openmmtools_tpu_torch.multistate import ParallelTemperingSampler

    fluid = LennardJonesFluid(nparticles=2048, device="cuda")
    move = LangevinDynamicsMove(timestep=0.002, collision_rate=1.0,
                                n_steps=200)
    sampler = ParallelTemperingSampler(mcmc_moves=move,
                                       number_of_iterations=2,
                                       online_analysis_interval=None)
    sampler.create(fluid.thermodynamic_state(120.0), fluid.sampler_state(),
                   temperatures=[120.0, 140.0, 160.0])
    bounds = [move._bound(s) for s in sampler._thermodynamic_states]
    assert all(b.force_path.name == "K1" for b in bounds)
    for b in bounds:
        for key in b.force_path.kernel.launches:
            b.force_path.kernel.launches[key] = 0
    sampler.run()
    total = {key: sum(b.force_path.kernel.launches[key] for b in bounds)
             for key in ("lj_forces", "lj_chunk")}
    assert total == {"lj_forces": 3 * 2, "lj_chunk": 3 * 2}
    u = sampler.energies_last_iteration
    for r, ss in enumerate(sampler.sampler_states):
        for c, st in enumerate(sampler._thermodynamic_states):
            dense = float(st.reduced_potential(ss))
            assert abs(u[r, c] - dense) <= 1e-5 * abs(dense)


# -- the equilibration slice: every energy through a bound integrator ----------


@pytest.mark.cuda
def test_cuda_fused_path_refuses_an_lj_scale(cuda):
    """An LJ fluid whose term reads a global LJ scale takes sweep mode, not
    K1 (whose kernel integrates at the term's own epsilon): its energies
    follow the scale (eps_ij, and so U, linear in it)."""
    fluid = LennardJonesFluid(nparticles=2048, device=cuda)
    term = fluid.system.terms[0].replace(lj_scale_param="lambda_sterics")
    system = fluid.system.replace(terms=(term,))
    bound = BAOABIntegrator(temperature=120.0).bind(system)
    assert bound.force_path.name != "K1" and bound.sweep_mode
    assert BAOABIntegrator(temperature=120.0).bind(
        fluid.system).force_path.name == "K1"
    u = bound.energies_at(fluid.positions, None,
                          [{"lambda_sterics": 1.0}, {"lambda_sterics": 0.5}])
    assert abs(float(u[1]) - 0.5 * float(u[0])) <= REL * abs(float(u[0]))


def _water(edge, dev):
    from openmmtools_tpu_torch.models import PMEWaterBox

    return PMEWaterBox(box_edge=edge, device=dev)


def _plain_energies(bound, sampler_states, params):
    from openmmtools_tpu_torch.ops import sweep_nb as tsw

    k = bound._sweep_kernel
    bound.force_path.kernel = tsw.PlainSweepNonbonded.like(k)
    try:
        return [float(bound.energies_at(ss.positions, ss.box_vectors,
                                        [params])[0])
                for ss in sampler_states]
    finally:
        bound.force_path.kernel = k


@pytest.mark.cuda
def test_cuda_dense_sum_is_refused_at_the_limit(cuda):
    """``ThermodynamicState.potential_energy`` raises on a 24,000-atom
    system on the card instead of taking the dense sum; below
    ``DENSE_LIMIT`` it serves."""
    w = _water(6.223, cuda)
    with pytest.raises(RuntimeError, match="dense"):
        w.thermodynamic_state(300.0).potential_energy(w.sampler_state())
    small = _water(3.0, cuda)
    assert small.system.n_particles < 4096
    u = small.thermodynamic_state(300.0).potential_energy(
        small.sampler_state())
    assert torch.isfinite(u)


@pytest.mark.cuda
def test_cuda_barostat_on_water_launches_k2(cuda):
    """A barostat attempt on the 24,000-atom water box: both energies by
    the context cache's bound integrator in sweep mode (one bound and one
    force launch for the two configurations together), against the plain
    sweep plus the remainder."""
    from openmmtools_tpu_torch.cache import ContextCache
    from openmmtools_tpu_torch.mcmc import (
        MonteCarloBarostatMove,
        potential_energies,
    )

    w = _water(6.223, cuda)
    ts = w.thermodynamic_state(300.0, pressure=1.0)
    cache = ContextCache()
    bound, _ = cache.get_context(ts)
    assert bound.sweep_mode
    k = bound._sweep_kernel
    baro = MonteCarloBarostatMove()
    mol_ids, n_mol = baro._molecules_for(ts.system)
    ss = w.sampler_state()
    for key in k.launches:
        k.launches[key] = 0
    trial, accept = baro.attempt(ts, ss, torch.tensor(0.01, device=cuda),
                                 torch.tensor(-1e30, device=cuda), mol_ids,
                                 n_mol, cache)
    torch.cuda.synchronize()
    assert k.launches == {"sweep_bound": 1, "sweep_forces": 1}
    assert k.batch_launches[("sweep_forces", 2)] >= 1
    assert bool(accept)
    got = [float(u) for u in potential_energies(ts, (ss, trial), cache)]
    want = _plain_energies(bound, (ss, trial), {})
    for g, p in zip(got, want):
        assert abs(g - p) <= REL * abs(p)


def _replica_gens(dev, n):
    return [torch.Generator(device=dev).manual_seed(40 + b)
            for b in range(n)]


@pytest.mark.cuda
def test_cuda_batched_mc_moves_launch_k2_at_2r(cuda):
    """A displacement and a rotation of the alchemical water as one batch
    of R = 3 replicas at three states of the ladder (3,000 atoms): each
    move one launch of each K2 kernel at B = 2R, for all the replicas'
    old and proposed energies; the accept decisions and positions those
    of one ``apply`` a replica with the same generators."""
    from openmmtools_tpu_torch.cache import ContextCache
    from openmmtools_tpu_torch.mcmc import (
        MCDisplacementMove,
        MCRotationMove,
        SequenceMove,
    )
    from openmmtools_tpu_torch.states import SamplerState as SS

    w, states = _alchemical_ladder(3.0, cuda)
    cache = ContextCache()
    bound, _ = cache.get_context(states[0])
    assert bound.sweep_mode and bound.force_path.alch is not None
    k = bound._sweep_kernel
    g = torch.Generator(device=cuda).manual_seed(3)
    sss = [SS(positions=w.positions + 1e-3 * torch.randn(
        w.positions.shape, generator=g, device=cuda),
        box_vectors=w.system.default_box) for _ in states]

    def tree():
        return SequenceMove([
            MCDisplacementMove(displacement_sigma=0.02,
                               atom_subset=[0, 1, 2]),
            MCRotationMove(atom_subset=[0, 1, 2])])

    batch_move, eager_move = tree(), tree()
    for key in k.launches:
        k.launches[key] = 0
    k.batch_launches.clear()
    out = batch_move.apply_batch(states, sss, _replica_gens(cuda, 3), cache)
    torch.cuda.synchronize()
    assert k.launches == {"sweep_bound": 2, "sweep_forces_alch": 2}
    assert dict(k.batch_launches) == {("sweep_bound", 6): 2,
                                      ("sweep_forces_alch", 6): 2}
    eager = [eager_move.apply(ts, ss, generator=gen, context_cache=cache)
             for ts, ss, gen in zip(states, sss, _replica_gens(cuda, 3))]
    for a, b in zip(out, eager):
        assert torch.equal(a.positions, b.positions)
    for m_b, m_e in zip(batch_move.move_list, eager_move.move_list):
        assert m_b.statistics == m_e.statistics
        assert m_b.n_proposed == 3


@pytest.mark.cuda
def test_cuda_barostat_batch_keeps_per_replica_boxes(cuda):
    """Five barostat attempts on three replicas of PMEWaterBox(3.0) at 1
    bar and 300, 320 and 350 K as one batch: K2 at B = 6 an attempt, each
    replica at its own box; the boxes those of one ``apply`` a replica
    with the same generators, not all equal, and the waters rigid."""
    from openmmtools_tpu_torch.cache import ContextCache
    from openmmtools_tpu_torch.mcmc import MonteCarloBarostatMove

    w = _water(3.0, cuda)
    states = [w.thermodynamic_state(t, pressure=1.0)
              for t in (300.0, 320.0, 350.0)]
    cache = ContextCache()
    bound, _ = cache.get_context(states[0])
    assert bound.sweep_mode
    k = bound._sweep_kernel
    sss = [w.sampler_state() for _ in states]

    def baro():
        return MonteCarloBarostatMove(volume_scale=0.03, n_attempts=5)

    batch_move, eager_move = baro(), baro()
    k.batch_launches.clear()
    out = batch_move.apply_batch(states, sss, _replica_gens(cuda, 3), cache)
    torch.cuda.synchronize()
    assert dict(k.batch_launches) == {("sweep_bound", 6): 5,
                                      ("sweep_forces", 6): 5}
    eager = [eager_move.apply(ts, ss, generator=gen, context_cache=cache)
             for ts, ss, gen in zip(states, sss, _replica_gens(cuda, 3))]
    assert batch_move.statistics == eager_move.statistics
    edges = set()
    c = w.system.constraints
    i, j = c.index[:, 0].long(), c.index[:, 1].long()
    for a, b in zip(out, eager):
        assert torch.equal(a.box_vectors, b.box_vectors)
        assert _rel(a.positions, b.positions) <= 1e-6
        edges.add(float(a.box_vectors[0, 0]))
        L = torch.diagonal(a.box_vectors)
        d = a.positions[i] - a.positions[j]
        d = d - L * torch.round(d / L)
        err = ((torch.linalg.norm(d, dim=1) - c.distance) / c.distance)
        assert float(err.abs().max()) <= 1e-5
    assert len(edges) > 1


@pytest.mark.cuda
def test_cuda_barostat_attempt_repeats_to_the_bit(cuda):
    """A barostat attempt of three water replicas, accepted, twice on the
    same inputs: the same positions to the bit (the molecules' centroid
    sums add in index order; atomics made them differ from run to run),
    and the centroids those of the CPU."""
    from openmmtools_tpu_torch.cache import ContextCache
    from openmmtools_tpu_torch.mcmc import MonteCarloBarostatMove

    w = _water(3.0, cuda)
    states = [w.thermodynamic_state(t, pressure=1.0)
              for t in (300.0, 320.0, 350.0)]
    cache = ContextCache()
    move = MonteCarloBarostatMove(volume_scale=0.03)
    ids, m = move._molecule_ids(w.system)
    sss = [w.sampler_state() for _ in states]
    eps = torch.tensor([0.01, -0.02, 0.015], device=cuda)
    log_u = torch.full((3,), -float("inf"), device=cuda)
    runs = [move.attempt_batch(states, sss, eps, log_u, ids, m, cache)
            for _ in range(2)]
    (a, acc_a), (b, acc_b) = runs
    assert bool(acc_a.all()) and torch.equal(acc_a, acc_b)
    for x, y in zip(a, b):
        assert torch.equal(x.positions, y.positions)
        assert torch.equal(x.box_vectors, y.box_vectors)
    x = torch.stack([ss.positions for ss in sss])
    card = torch.zeros((m, 3, 3), device=cuda).index_put_(
        (ids,), x.transpose(0, 1), accumulate=True)
    host = torch.zeros((m, 3, 3)).index_add_(0, ids.cpu(),
                                              x.transpose(0, 1).cpu())
    assert torch.equal(card.cpu(), host)


@pytest.mark.cuda
def test_cuda_minimize_on_water_takes_k2(cuda):
    """``minimize`` on the 24,000-atom water box: FIRE through the cached
    bound integrator's sweep path with SETTLE, one K2 evaluation an
    iteration plus the final and the acceptance check's two; rigid
    waters, a lower energy."""
    from openmmtools_tpu_torch.cache import ContextCache

    w = _water(6.223, cuda)
    ts = w.thermodynamic_state(300.0)
    cache = ContextCache()
    bound, _ = cache.get_context(ts)
    k = bound._sweep_kernel
    for key in k.launches:
        k.launches[key] = 0
    ss = w.sampler_state()
    out = minimize(ts, ss, max_iterations=10, context_cache=cache)
    torch.cuda.synchronize()
    assert k.launches == {"sweep_bound": 13, "sweep_forces": 13}
    u0, u1 = (float(bound.energies_at(s.positions, None, [{}])[0])
              for s in (ss, out))
    assert u1 < u0
    c = ts.system.constraints
    d = out.positions[c.index[:, 0].long()] - out.positions[
        c.index[:, 1].long()]
    assert float(((d.norm(dim=-1) - c.distance) / c.distance).abs().max()) \
        <= 1e-5


@pytest.mark.cuda
def test_cuda_parallel_tempering_on_water_launches_k2(cuda):
    """Parallel tempering on a 3,000-atom water box: the replicas' moves
    and their O(N) energies through K2 as batches (5 + 1 + 1 of each
    kernel an iteration), the columns against the plain sweep plus the
    remainder."""
    from openmmtools_tpu_torch.mcmc import LangevinDynamicsMove
    from openmmtools_tpu_torch.multistate import ParallelTemperingSampler

    w = _water(3.0, cuda)
    move = LangevinDynamicsMove(timestep=0.001, collision_rate=1.0,
                                n_steps=5)
    sampler = ParallelTemperingSampler(mcmc_moves=move,
                                       number_of_iterations=1,
                                       online_analysis_interval=None)
    sampler.create(w.thermodynamic_state(300.0), w.sampler_state(),
                   temperatures=[300.0, 330.0])
    bounds = [move._bound(s) for s in sampler._thermodynamic_states]
    kernels = {id(b._sweep_kernel): b._sweep_kernel for b in bounds}
    assert all(b.sweep_mode for b in bounds)
    for kk in kernels.values():
        for key in kk.launches:
            kk.launches[key] = 0
    sampler.run()
    torch.cuda.synchronize()
    total = {key: sum(kk.launches[key] for kk in kernels.values())
             for key in ("sweep_bound", "sweep_forces")}
    assert total == {"sweep_bound": 7, "sweep_forces": 7}
    u = sampler.energies_last_iteration
    beta = sampler._stacked_sampled.beta.numpy()
    for r, ss in enumerate(sampler.sampler_states):
        (U,) = _plain_energies(sampler._matrix_bound(), [ss], {})
        for c in range(2):
            assert abs(u[r, c] - beta[c] * U) <= REL * abs(beta[c] * U)


@pytest.mark.cuda
def test_cuda_unsampled_state_takes_its_own_k2(cuda):
    """An unsampled state with a system of its own (the water box with its
    oxygens restrained) is evaluated by the first move's integrator bound
    to that system: its own sweep kernel, one evaluation a replica."""
    from openmmtools_tpu_torch.cache import global_context_cache
    from openmmtools_tpu_torch.forces import restrain_atoms
    from openmmtools_tpu_torch.mcmc import LangevinDynamicsMove
    from openmmtools_tpu_torch.multistate import MultiStateSampler
    from openmmtools_tpu_torch.states import ThermodynamicState

    w = _water(3.0, cuda)
    restrained = restrain_atoms(w.system, w.positions,
                                list(range(0, w.system.n_particles, 3)))
    move = LangevinDynamicsMove(timestep=0.001, collision_rate=1.0,
                                n_steps=2)
    sampler = MultiStateSampler(mcmc_moves=move, number_of_iterations=1,
                                online_analysis_interval=None)
    unsampled = ThermodynamicState(system=restrained, temperature=300.0)
    sampler.create([w.thermodynamic_state(300.0)], w.sampler_state(),
                   unsampled_thermodynamic_states=[unsampled])
    integ = move._get_integrator(sampler._thermodynamic_states[0])
    bound, _ = global_context_cache.get_context(unsampled, integ)
    assert bound.sweep_mode and bound.system is restrained
    k = bound._sweep_kernel
    for key in k.launches:
        k.launches[key] = 0
    sampler.run()
    torch.cuda.synchronize()
    assert k.launches == {"sweep_bound": 1, "sweep_forces": 1}
    assert np.isfinite(sampler.energies_last_iteration).all()


@pytest.mark.cuda
def test_cuda_equilibration_launches_k2_in_every_stage(cuda):
    """The four-stage protocol on a 3,000-atom water box, short stages:
    each stage's bound integrator in sweep mode with K2's launches as
    counted, the restraint among the sweep's leftover terms in the
    restrained stages."""
    from openmmtools_tpu_torch.cache import ContextCache
    from openmmtools_tpu_torch.forces import PositionalRestraintTerm
    from openmmtools_tpu_torch.utils.equilibration import (
        EquilibrationStage,
        run_gentle_equilibration,
    )

    w = _water(3.0, cuda)
    ox = list(range(0, w.system.n_particles, 3))
    r = dict(restraint_sigma=0.3, restrained_atoms=ox)
    stages = [EquilibrationStage("minimize", n_steps=10, **r),
              EquilibrationStage("nvt", n_steps=20, **r),
              EquilibrationStage("npt", pressure=1.0, n_steps=50, **r),
              EquilibrationStage("npt", pressure=1.0, n_steps=50)]
    cache = ContextCache()
    out = run_gentle_equilibration(w.thermodynamic_state(300.0),
                                   w.sampler_state(), stages, seed=3,
                                   context_cache=cache)
    torch.cuda.synchronize()
    bounds = cache.bound_integrators()
    # FIRE 10 + 3; dynamics n + 1; the barostat's two attempts one launch
    # each, the old and trial configurations as one batch
    assert [b._sweep_kernel.launches["sweep_forces"] for b in bounds] == \
        [13, 21, 53, 53]
    assert [b._sweep_kernel.launches["sweep_bound"] for b in bounds] == \
        [13, 21, 53, 53]
    for b, restrained in zip(bounds, (True, True, True, False)):
        assert b.sweep_mode
        assert (PositionalRestraintTerm in [
            type(t) for t in b.force_path.leftover]) == restrained
    assert torch.isfinite(out.positions).all()
    assert torch.isfinite(out.box_vectors).all()


@pytest.mark.cuda
def test_cuda_neighbor_mode_engages_from_100000_atoms(cuda):
    """On the card neighbour mode engages only from 100,000 atoms, and
    only with sweep mode off (the sweep replaces it)."""
    small = LennardJonesFluid(nparticles=40_000, device="cuda")
    assert not BAOABIntegrator(sweep=None).bind(small.system).neighbor_mode
    big = LennardJonesFluid(nparticles=100_000, device="cuda")
    bound = BAOABIntegrator(sweep=None).bind(big.system)
    assert bound.neighbor_mode and bound.force_path.name != "K1"
    assert bound.force_path.k_max < 100
    swept = BAOABIntegrator().bind(big.system)
    assert swept.sweep_mode and not swept.neighbor_mode


@pytest.mark.cuda
def test_cuda_gbsa_float32_against_cpu_float64(cuda):
    """GBSA-OBC in float32 on the card against float64 on the CPU (2e-4
    of scale)."""
    from openmmtools_tpu_torch.models import CustomGBForceSystem
    from openmmtools_tpu_torch.ops.gbsa import GBSAOBCTerm
    from openmmtools_tpu_torch.system import value_and_grad

    ts = CustomGBForceSystem(device="cuda")
    gb = next(t for t in ts.system.terms if isinstance(t, GBSAOBCTerm))
    u32, g32 = value_and_grad(lambda xx: gb.energy(xx, None), ts.positions)
    gb64 = gb.to(device="cpu", dtype=torch.float64)
    x64 = ts.positions.cpu().double()
    u64, g64 = value_and_grad(lambda xx: gb64.energy(xx, None), x64)
    assert abs(float(u32) - float(u64)) <= REL * abs(float(u64))
    assert float((g32.cpu().double() - g64).abs().max()) <= \
        REL * float(g64.abs().max())


@pytest.mark.cuda
def test_cuda_platform_kernel_check_reads_the_launch_counters(cuda):
    """The parity sweep's kernel check launches K1 on an LJ fluid and K2 on
    a water box, and records each kernel's launches."""
    from openmmtools_tpu_torch.models import WaterBox
    from openmmtools_tpu_torch.scripts import test_platforms

    for cls, path, keys in (
            (LennardJonesFluid, "K1", ("lj_forces", "lj_chunk")),
            (WaterBox, "K2", ("sweep_bound", "sweep_forces"))):
        ts = cls(device="cpu")
        status, detail, got, launches = test_platforms._kernel_check(
            ts, test_platforms.ENERGY_TOLERANCE_KJ, "cuda", 0.0)
        assert status == "ok", detail
        assert got == path
        assert all(launches[k] >= 1 for k in keys), launches


@pytest.mark.cuda
def test_cuda_platform_sweep_takes_the_bound_integrator_at_the_limit(cuda):
    """From DENSE_LIMIT atoms up the sweep's cuda/f32 evaluation goes
    through a bound integrator's energy_forces_at (sweep mode: K2), not the
    refused dense sum, and agrees with the CPU float64 dense sum."""
    from openmmtools_tpu_torch.models import PMEWaterBox
    from openmmtools_tpu_torch.scripts import test_platforms
    from openmmtools_tpu_torch.system import DENSE_LIMIT

    ts = PMEWaterBox(box_edge=3.6, device="cpu")
    assert ts.system.n_particles >= DENSE_LIMIT
    u, f, via = test_platforms._evaluate(ts.system, torch.float32, "cuda",
                                         ts.positions)
    u64, f64, via64 = test_platforms._evaluate(ts.system, torch.float64,
                                               "cpu", ts.positions)
    assert via == "energy_forces_at" and via64 == "dense"
    assert abs(u - u64) <= test_platforms.ENERGY_TOLERANCE_KJ * max(
        1.0, abs(u64) * 1e-5 / test_platforms.ENERGY_TOLERANCE_KJ)
    assert np.abs(f - f64).max() <= test_platforms.FORCE_RTOL * max(
        np.abs(f64).max(), 1.0)


@pytest.mark.cuda
def test_cuda_virtual_sites_above_the_limit_take_k2(cuda):
    """A four-site water box of DENSE_LIMIT atoms or more takes sweep mode
    by default on the card, its M-sites rebuilt from their parents: K2
    launches at every step, and after 100 steps U and F agree with the CPU
    float64 dense sum (2e-4 of scale)."""
    from openmmtools_tpu_torch.models import FourSiteWaterBox
    from openmmtools_tpu_torch.system import DENSE_LIMIT, make_energy_force_fn

    ts = FourSiteWaterBox(box_edge=3.3, device="cuda")
    assert ts.system.n_particles >= DENSE_LIMIT
    bound = BAOABIntegrator(temperature=300.0, timestep=0.002).bind(ts.system)
    assert bound.sweep_mode and bound.force_path.vsites is not None
    k = bound._sweep_kernel
    state = bound.initial_state(ts.sampler_state(),
                                torch.Generator(device="cuda").manual_seed(8))
    for key in k.launches:
        k.launches[key] = 0
    state = bound.run(state, 100)
    assert k.launches == {"sweep_bound": 100, "sweep_forces": 100}
    s64 = ts.system.to(device="cpu", dtype=torch.float64)
    u64, f64 = make_energy_force_fn(s64)(state.positions.cpu().double())
    assert abs(float(state.potentials[0]) - float(u64)) <= REL * abs(
        float(u64))
    assert float((state.forces[0].cpu().double() - f64).abs().max()) <= \
        REL * float(f64.abs().max())


# -- replicas as one batched axis: K2's batch, the batched route, the mesh ----


def _ladder_sets(edge, dev, n_rep, seed):
    """K2's batched inputs on ``n_rep`` perturbed configurations of the
    alchemical water box, each at one state of the ladder: (k, plain, xT,
    par, excl, L, lam)."""
    from openmmtools_tpu_torch.ops import sweep_nb as tsw

    w, states = _alchemical_ladder(edge, dev)
    bound = BAOABIntegrator(temperature=300.0).bind(w.system)
    k = bound._sweep_kernel
    term = bound.force_path.alch
    g = torch.Generator(device=dev).manual_seed(seed)
    ins = []
    for r in range(n_rep):
        x = w.positions + 2e-3 * torch.randn(w.positions.shape, generator=g,
                                              device=dev)
        params = {n: torch.tensor(float(v), device=dev) for n, v in
                  states[r % len(states)].global_params.items()}
        xT, par, excl, L, _ = tsw.sorted_inputs(term, x, w.system.default_box,
                                                k)
        lam = term.sweep_lambdas(params, xT)[0].contiguous()
        ins.append((xT, par, excl, L, lam))
    stacked = [torch.stack([i[c] for i in ins]).contiguous()
               for c in range(5)]
    return (k, tsw.PlainSweepNonbonded.like(k), *stacked)


@pytest.mark.cuda
def test_cuda_batched_k2_of_one_is_the_single_call(cuda):
    """A batch of one sort set and one evaluation gives today's single
    call's bound, forces and energy to the bit."""
    k, _, xT, par, excl, L, lam = _ladder_sets(3.0, cuda, 1, 11)
    flag = torch.ones((1,), dtype=torch.bool, device=cuda)
    zero = torch.zeros((1,), dtype=torch.int32, device=cuda)
    nb = k.measure_bound(xT, L, flag, zero)
    nb1 = k.measure_bound(xT[0], L[0], flag[0], zero[0])
    assert torch.equal(nb, nb1)
    F, U = k.sweep(xT, par, excl, L, nb, lam)
    F1, U1 = k.sweep(xT[0], par[0], excl[0], L[0], nb1, lam[0])
    assert F.shape == (1, 3, k.n_pad) and U.shape == (1,)
    assert torch.equal(F[0], F1) and torch.equal(U, U1)
    assert k.batch_launches[("sweep_forces_alch", 1)] == 2


@pytest.mark.cuda
def test_cuda_batched_k2_of_nine_equals_nine_single_launches(cuda):
    """B = 9 evaluations on 9 sort sets in one launch of each kernel: the
    bits of 9 single launches, and the plain version's bounds and forces;
    then 27 evaluations over the 9 sets (rep) likewise."""
    k, plain, xT, par, excl, L, lam = _ladder_sets(3.0, cuda, 9, 12)
    flags = torch.ones((9,), dtype=torch.bool, device=cuda)
    bound0 = torch.zeros((9,), dtype=torch.int32, device=cuda)
    # one set keeps its bound, the others rebuild
    flags[4] = False
    bound0[4] = 7
    nb = k.measure_bound(xT, L, flags, bound0)
    assert int(nb[4]) == 7
    assert torch.equal(nb.cpu(), plain.measure_bound(xT, L, flags,
                                                     bound0).cpu())
    for r in range(9):
        assert torch.equal(nb[r:r + 1], k.measure_bound(xT[r], L[r],
                                                        flags[r], bound0[r]))
    F, U = k.sweep(xT, par, excl, L, nb, lam)
    for r in range(9):
        F1, U1 = k.sweep(xT[r], par[r], excl[r], L[r], nb[r:r + 1], lam[r])
        assert torch.equal(F[r], F1) and torch.equal(U[r:r + 1], U1)
    F_ref, U_ref = plain.sweep(xT, par, excl, L, nb, lam)
    assert _rel(F, F_ref) <= REL
    assert float(((U - U_ref).abs() / U_ref.abs()).max()) <= REL
    rep = torch.arange(9, device=cuda).repeat(3).to(torch.int32)
    par27 = par[rep.long()].contiguous()
    lam27 = torch.roll(lam[rep.long()], 1, dims=0).contiguous()
    F27, U27 = k.sweep(xT, par27, excl, L, nb, lam27, rep)
    for b in (0, 13, 26):
        r = int(rep[b])
        F1, U1 = k.sweep(xT[r], par27[b], excl[r], L[r], nb[r:r + 1],
                         lam27[b])
        assert torch.equal(F27[b], F1) and torch.equal(U27[b:b + 1], U1)


@pytest.mark.cuda
def test_cuda_batched_route_of_a_ladder_against_its_eager_loop(cuda):
    """Three replicas of the 3,000-atom alchemical ladder, 20 steps of 2 fs
    through the batched program and one by one with the same generators:
    the final U and forces within 2e-4 of scale."""
    from openmmtools_tpu_torch.mcmc import LangevinSplittingDynamicsMove

    w, states = _alchemical_ladder(3.0, cuda)
    move = LangevinSplittingDynamicsMove(timestep=0.002, collision_rate=1.0,
                                         n_steps=20)
    bound = move._bound(states[0])
    ts = [states[0], states[1], states[2]]
    ss = [w.sampler_state()] * 3

    def gens():
        return [torch.Generator(device=cuda).manual_seed(21 + i)
                for i in range(3)]

    batch = bound.run(bound.initial_state_batch(ss, gens(),
                                                thermodynamic_states=ts), 20)
    for b, (s, g, st) in enumerate(zip(ss, gens(), ts)):
        one = bound.run(bound.initial_state(s, g, thermodynamic_state=st),
                        20)
        assert abs(float(batch.potentials[0][b]) - float(one.potentials[0])) \
            <= REL * abs(float(one.potentials[0]))
        assert _rel(batch.forces[0][b], one.forces[0]) <= REL


@pytest.mark.cuda
def test_cuda_replica_mesh_defaults_to_every_card(cuda):
    from openmmtools_tpu_torch.parallel import replica_mesh

    mesh = replica_mesh()
    assert mesh.size == torch.cuda.device_count()
    assert all(d.type == "cuda" for d in mesh.devices)
    assert replica_mesh(n_devices=1).devices == (torch.device("cuda", 0),)


@pytest.mark.cuda
def test_cuda_replica_mesh_over_every_card_matches_one_card(cuda):
    """Six replicas of the 3,000-atom alchemical ladder on a mesh of every
    card (contiguous blocks, each advanced as one batch on its card, the
    system moved there) against the same sampler on one card: energies and
    positions within 2e-4 after two iterations (the blocks' smaller
    batches sum the float32 energies in another order: about 1e-6 of U
    on four H100s)."""
    from openmmtools_tpu_torch.mcmc import LangevinSplittingDynamicsMove
    from openmmtools_tpu_torch.multistate import ReplicaExchangeSampler
    from openmmtools_tpu_torch.parallel import replica_mesh

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards or more")
    w, states = _alchemical_ladder(3.0, cuda)

    def run(mesh):
        move = LangevinSplittingDynamicsMove(timestep=0.002,
                                             collision_rate=1.0, n_steps=5)
        sampler = ReplicaExchangeSampler(mcmc_moves=move,
                                         number_of_iterations=2,
                                         online_analysis_interval=None,
                                         rng_seed=4)
        sampler.create(states, [w.sampler_state()] * 6,
                       initial_thermodynamic_states=[0, 1, 2, 0, 1, 2],
                       mesh=mesh)
        sampler.minimize(max_iterations=5)
        sampler.run()
        return sampler

    mesh = replica_mesh()
    spread = run(mesh)
    devices = {ss.positions.device for ss in spread.sampler_states}
    assert len(devices) == min(6, mesh.size)
    one = run(None)
    assert spread.propagation_route == one.propagation_route == "batched"
    u_s, u_1 = spread.energies_last_iteration, one.energies_last_iteration
    assert np.abs(u_s - u_1).max() <= REL * np.abs(u_1).max()
    assert (spread.replica_states == one.replica_states).all()
    for a, b in zip(spread.sampler_states, one.sampler_states):
        assert _rel(a.positions.to(b.positions.device), b.positions) <= REL


def _chains_in_water(tmp_path, device):
    """Two hexanes in 188 waters of PMEWaterBox(2.0), written as a prmtop
    by chip_smoke.py's writer and loaded with PME and h-bond constraints."""
    import chip_smoke
    from openmmtools_tpu_torch.models import amber

    top = chip_smoke.solvated_chains(2, 6, 2.0)
    path = tmp_path / "chains.prmtop"
    chip_smoke.write_prmtop(path, top)
    system = amber.create_system_from_prmtop(
        str(path), nonbonded_method="pme", device=device)
    x = torch.as_tensor(np.asarray(top.positions, np.float32), device=device)
    return system, x


@pytest.mark.cuda
def test_cuda_prmtop_stand_in_takes_k2_with_settle_mshake_and_fused_recip(
        cuda, tmp_path):
    """The loader's explicit-solvent system in sweep mode on the card: K2's
    standard variant, SETTLE on the waters and M-SHAKE on the CH clusters,
    the reciprocal exclusion correction fused with the exception add-back;
    20 steps launch each K2 kernel once a step, the constraints hold."""
    system, x = _chains_in_water(tmp_path, cuda)
    bound = BAOABIntegrator(temperature=300.0, sweep="force").bind(system)
    assert bound.sweep_mode and bound.force_path.alch is None
    settle = bound.constraint_solver.settle
    assert settle is not None and settle.a.shape[0] == 188
    assert bound.constraint_solver.clusters is not None
    assert bound.force_path.recip is system.terms[4]
    k = bound._sweep_kernel
    state = bound.initial_state(SamplerState(positions=x,
                                             box_vectors=system.default_box),
                                torch.Generator(device=cuda).manual_seed(1))
    for key in k.launches:
        k.launches[key] = 0
    state = bound.run(state, 20)
    assert k.launches == {"sweep_bound": 20, "sweep_forces": 20}
    assert not bool(state.sweep_overflow)
    c = system.constraints
    d = state.positions[c.index[:, 0].long()] - state.positions[
        c.index[:, 1].long()]
    L = torch.diagonal(system.default_box)
    d = d - L * torch.round(d / L)
    err = ((torch.linalg.norm(d, dim=1) - c.distance) / c.distance).abs()
    assert float(err.max()) <= 1e-5


@pytest.mark.cuda
def test_cuda_prmtop_stand_in_against_the_plain_version(cuda, tmp_path):
    """U and F of the stand-in through K2 against the plain sweep plus the
    same remainder, and against the CPU float64 dense sum."""
    from openmmtools_tpu_torch.ops import sweep_nb as tsw
    from openmmtools_tpu_torch.system import make_energy_fn, value_and_grad

    system, x = _chains_in_water(tmp_path, cuda)
    bound = BAOABIntegrator(temperature=300.0, sweep="force").bind(system)
    k = bound._sweep_kernel
    u, f = bound.energy_forces_at(x, system.default_box, {})
    bound.force_path.kernel = tsw.PlainSweepNonbonded.like(k)
    u_p, f_p = bound.energy_forces_at(x, system.default_box, {})
    bound.force_path.kernel = k
    assert abs(float(u) - float(u_p)) <= REL * abs(float(u_p))
    scale = float(f_p.abs().max())
    assert float((f - f_p).abs().max()) <= REL * scale
    s64 = system.to(device="cpu", dtype=torch.float64)
    u64, g64 = value_and_grad(
        lambda xx: make_energy_fn(s64)(xx, s64.default_box),
        x.cpu().double())
    assert abs(float(u) - float(u64)) <= 1e-4 * abs(float(u64))
    assert float((f.cpu().double() + g64).abs().max()) <= REL * float(
        g64.abs().max())


@pytest.mark.cuda
def test_cuda_tracing_counts_k2_rebuilds_and_the_backward_s_cause(
        cuda, monkeypatch):
    """Three replicas of the alchemical ladder, 20 batched steps of the
    eager program (the step's CUDA graph off) under a profile (tracing
    on): ``k2.rebuilds`` equals the rebuild flags handed to K2 and
    ``k2.sort_sets`` the sort sets; the PME backward's spans run on
    autograd's worker thread with ``forces.remainder`` as cause; each span
    starts within 100 us of its profiler range; no span shows on the device
    as an annotation."""
    import collections
    import threading

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from openmmtools_tpu_torch.mcmc import LangevinSplittingDynamicsMove
    from openmmtools_tpu_torch.utils import tracing

    w, states = _alchemical_ladder(3.0, cuda)
    move = LangevinSplittingDynamicsMove(timestep=0.002, collision_rate=1.0,
                                         n_steps=20)
    bound = move._bound(states[0])
    monkeypatch.setattr(bound, "_graph_for", lambda state, skip: None)
    k = bound._sweep_kernel
    flags = []
    evaluate = k.evaluate

    def counted(xT, par, excl, L, rebuild, *rest):
        flags.append((int(rebuild.sum()), rebuild.shape[0]))
        return evaluate(xT, par, excl, L, rebuild, *rest)

    ts, ss = states[:3], [w.sampler_state()] * 3

    def gens():
        return [torch.Generator(device=cuda).manual_seed(31 + i)
                for i in range(3)]

    move.apply_batch(ts, ss, gens())
    k.evaluate = counted
    tracing.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            move.apply_batch(ts, ss, gens())
            torch.cuda.synchronize()
        snap = tracing.snapshot()
    finally:
        del k.evaluate
        tracing.reset()
    assert len(flags) == 21
    # one SETTLE call, one kernel launch, a constraints span
    projections = sum(s[0].startswith("constraints.") for s in snap.spans)
    assert snap.counters == {"k2.rebuilds": sum(f for f, _ in flags),
                             "k2.sort_sets": sum(r for _, r in flags),
                             "integrator.steps": 20,
                             "constraints.settle": projections,
                             "constraints.settle_kernel": projections}
    backward = [s for s in snap.spans if s[0] == "pme.backward"]
    assert len(backward) == 3 * 21
    assert {s[3] for s in backward} == {"forces.remainder"}
    assert threading.get_ident() not in {s[4] for s in backward}
    names = {s[0] for s in snap.spans}
    events = prof.profiler.kineto_results.events()
    ranges = collections.defaultdict(list)
    for e in events:
        if e.name() in names:
            assert e.device_type() == DeviceType.CPU, e.name()
            ranges[e.name()].append(e.start_ns())
    offsets = []
    for name in names:
        starts = sorted(s[1] for s in snap.spans if s[0] == name)
        assert len(starts) == len(ranges[name]), name
        offsets += [lo - r for lo, r in zip(starts, sorted(ranges[name]))]
    print(f"span start less its profiler range's: median "
          f"{sorted(offsets)[len(offsets) // 2]} ns, range "
          f"[{min(offsets)}, {max(offsets)}] ns over {len(offsets)} spans")
    assert max(abs(o) for o in offsets) <= 100_000


# -- the step program as one CUDA graph a step (integrators/step_graph.py) ---


def _graph_run(bound, start, n_steps, graphs, monkeypatch):
    """``bound.run(start(), n_steps)`` with the step's CUDA graph on or off,
    traced: (the state, K2's launches and batch launches in the run, the
    tracing counters)."""
    from openmmtools_tpu_torch.utils import tracing

    k = bound._sweep_kernel
    with monkeypatch.context() as m:
        if not graphs:
            m.setattr(bound, "_graph_for", lambda state, skip: None)
        state = start()
        launches = dict(k.launches)
        batch = collections.Counter(k.batch_launches)
        tracing.reset()
        tracing.enable()
        try:
            state = bound.run(state, n_steps)
            torch.cuda.synchronize()
            counters = tracing.snapshot().counters
        finally:
            tracing.disable()
            tracing.reset()
    return (state, {n: k.launches[n] - launches[n] for n in k.launches},
            collections.Counter(k.batch_launches) - batch, counters)


def _same_states(a, b):
    for f in ("positions", "velocities", "heat", "shadow_work",
              "protocol_work", "n_accepted", "n_proposed", "sweep_snap",
              "sweep_nblk"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for x, y in zip(a.forces + a.potentials, b.forces + b.potentials):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert a.step_count == b.step_count
    gens = (a.generator, b.generator)
    if not isinstance(a.generator, tuple):
        gens = ((a.generator,), (b.generator,))
    for g, h in zip(*gens):
        assert g is not h and torch.equal(g.get_state(), h.get_state())


@pytest.mark.cuda
def test_cuda_step_graph_replays_equal_eager_steps_to_the_bit(
        cuda, monkeypatch):
    """Three replicas of the 3,000-atom alchemical ladder (SETTLE, PME, K2's
    alchemical variant), 20 steps of 2 fs measuring heat, re-sorted every 7
    steps: the replayed steps give the eager steps' positions, velocities,
    forces, potentials and heat to the bit, the generators end at the same
    offsets, and K2's launches, its launches by batch size, ``k2.rebuilds``,
    ``k2.sort_sets`` and the SETTLE counters read as the eager run's, K2
    counting its replayed launches on the device. One capture, after the
    first step ran eagerly; the other 19 steps replayed."""
    w, states = _alchemical_ladder(3.0, cuda)
    bound = LangevinIntegrator(temperature=300.0, timestep=0.002,
                               collision_rate=1.0, measure_heat=True,
                               sweep_sort_interval=7).bind(w.system)
    assert bound.sweep_mode and bound._graph_program
    assert not bound._vproj_skip
    ts, ss = states[:3], [w.sampler_state()] * 3

    def start():
        gens = [torch.Generator(device=cuda).manual_seed(41 + i)
                for i in range(3)]
        return bound.initial_state_batch(ss, gens, thermodynamic_states=ts)

    eager, l_e, b_e, c_e = _graph_run(bound, start, 20, False, monkeypatch)
    graphed, l_g, b_g, c_g = _graph_run(bound, start, 20, True, monkeypatch)
    _same_states(graphed, eager)
    assert float(graphed.heat.abs().min()) > 0
    assert l_g == l_e and b_g == b_e
    assert b_g == {("sweep_bound", 3): 20, ("sweep_forces_alch", 3): 20}
    # five SETTLE projections a step, each one kernel launch
    assert c_e == {"k2.rebuilds": c_e["k2.rebuilds"], "k2.sort_sets": 60,
                   "integrator.steps": 20, "constraints.settle": 100,
                   "constraints.settle_kernel": 100}
    assert c_g == {**c_e, "integrator.graph_steps": 19,
                   "integrator.graph_captures": 1}
    assert [g is not None for g in bound._graphs.values()] == [True]


@pytest.mark.cuda
def test_cuda_step_graph_serves_mixed_replicas_with_one_capture(
        cuda, monkeypatch):
    """Three runs of three replicas whose states (kT and lambdas) are
    permuted between runs, as mixing does, each from the last run's
    configurations: one capture serves all three, and each run equals the
    eager program's to the bit."""
    w, states = _alchemical_ladder(3.0, cuda)
    temps = [300.0, 320.0, 340.0]
    lams = [dict(st.global_params) for st in states]
    bound = BAOABIntegrator(temperature=300.0, timestep=0.002,
                            collision_rate=1.0).bind(w.system)
    assert bound._vproj_skip
    orders = [[0, 1, 2], [2, 0, 1], [1, 2, 0]]
    ss = {True: [w.sampler_state()] * 3, False: [w.sampler_state()] * 3}
    captures = 0
    for i, order in enumerate(orders):
        out = {}
        for graphs in (False, True):
            def start():
                gens = [torch.Generator(device=cuda).manual_seed(
                    100 * i + n) for n in range(3)]
                return bound.initial_state_batch(
                    ss[graphs], gens, temperatures=[temps[s] for s in order],
                    global_params=[lams[s] for s in order])

            out[graphs], *_, counters = _graph_run(bound, start, 10, graphs,
                                                   monkeypatch)
            ss[graphs] = bound.sampler_states_from(out[graphs])
            captures += counters.get("integrator.graph_captures", 0)
        _same_states(out[True], out[False])
    assert captures == 1 and len(bound._graphs) == 1


@pytest.mark.cuda
def test_cuda_step_graph_replays_a_single_replica(cuda, monkeypatch):
    """One replica, (N, 3), 20 steps: replayed as eager, to the bit."""
    w, states = _alchemical_ladder(3.0, cuda)
    bound = BAOABIntegrator(temperature=300.0, timestep=0.002,
                            collision_rate=1.0).bind(w.system)

    def start():
        return bound.initial_state(
            w.sampler_state(), torch.Generator(device=cuda).manual_seed(5),
            thermodynamic_state=states[2])

    eager, l_e, b_e, _ = _graph_run(bound, start, 20, False, monkeypatch)
    graphed, l_g, b_g, c_g = _graph_run(bound, start, 20, True, monkeypatch)
    assert graphed.positions.shape == (w.system.n_particles, 3)
    _same_states(graphed, eager)
    assert l_g == l_e and b_g == b_e
    assert c_g["integrator.graph_steps"] == 19


@pytest.mark.cuda
def test_cuda_step_graph_leaves_the_fused_path_and_ncmc_alone(cuda):
    """K1's fused path and an NCMC protocol (H steps) keep their own
    routes on the card: no graph is captured."""
    from openmmtools_tpu_torch.integrators import (
        AlchemicalNonequilibriumLangevinIntegrator,
    )

    fluid = _calm(1000)
    fused = BAOABIntegrator(temperature=120.0).bind(fluid.system)
    assert fused.force_path.name == "K1" and not fused._graph_program
    w, states = _alchemical_ladder(3.0, cuda)
    integ = AlchemicalNonequilibriumLangevinIntegrator(
        alchemical_functions={"lambda_electrostatics": "1 - lambda"},
        n_steps_neq=5, temperature=300.0, collision_rate=1.0,
        timestep=0.002)
    ncmc = integ.bind(w.system)
    assert ncmc.sweep_mode and not ncmc._graph_program
    state = ncmc.initial_state(
        w.sampler_state(), torch.Generator(device=cuda).manual_seed(3),
        global_params={**integ.initial_params(), "lambda_sterics": 1.0})
    ncmc.run(state, 5)
    assert ncmc._graphs == {}


@pytest.mark.cuda
def test_cuda_step_graph_refuses_a_generator_shared_by_replicas(cuda):
    """Three replicas drawing from one generator run eagerly (the graph's
    generators, one a replica, could not mirror it); the same replicas
    with a generator each take a graph."""
    w, states = _alchemical_ladder(3.0, cuda)
    bound = BAOABIntegrator(temperature=300.0, timestep=0.002,
                            collision_rate=1.0).bind(w.system)
    shared = torch.Generator(device=cuda).manual_seed(9)
    state = bound.initial_state_batch([w.sampler_state()] * 3, [shared] * 3,
                                      thermodynamic_states=states)
    bound.run(state, 3)
    assert bound._graphs == {}
    gens = [torch.Generator(device=cuda).manual_seed(9 + i)
            for i in range(3)]
    state = bound.initial_state_batch([w.sampler_state()] * 3, gens,
                                      thermodynamic_states=states)
    bound.run(state, 3)
    assert [g is not None for g in bound._graphs.values()] == [True]


@pytest.mark.cuda
def test_cuda_step_graph_replays_ghmc_s_metropolis_block(cuda, monkeypatch):
    """GHMC ('O { V R V } O') on three replicas of the ladder: the block's
    accept test and momentum flip replay as the eager steps, to the bit,
    acceptance counts included."""
    from openmmtools_tpu_torch.integrators import GHMCIntegrator

    w, states = _alchemical_ladder(3.0, cuda)
    bound = GHMCIntegrator(temperature=300.0, timestep=0.002,
                           collision_rate=1.0).bind(w.system)
    assert bound.sweep_mode and bound._graph_program

    def start():
        gens = [torch.Generator(device=cuda).manual_seed(61 + i)
                for i in range(3)]
        return bound.initial_state_batch([w.sampler_state()] * 3, gens,
                                         thermodynamic_states=states)

    eager, l_e, b_e, _ = _graph_run(bound, start, 20, False, monkeypatch)
    graphed, l_g, b_g, c_g = _graph_run(bound, start, 20, True, monkeypatch)
    _same_states(graphed, eager)
    assert int(graphed.n_proposed.sum()) == 60
    assert l_g == l_e and b_g == b_e
    assert c_g["integrator.graph_steps"] == 19


@pytest.mark.cuda
def test_cuda_step_graph_outlives_a_larger_batch_on_its_kernels(
        cuda, monkeypatch):
    """A graph captured at B = 3, then ``energies_batch`` of 9 pairs on the
    same bound (K2 at B = 9: tickets and scratch of their own) and the
    freed memory handed out again, filled: the next replayed run equals
    the eager run to the bit, with no new capture."""
    w, states = _alchemical_ladder(3.0, cuda)
    bound = BAOABIntegrator(temperature=300.0, timestep=0.002,
                            collision_rate=1.0).bind(w.system)

    def start(seed):
        def make():
            gens = [torch.Generator(device=cuda).manual_seed(seed + i)
                    for i in range(3)]
            return bound.initial_state_batch([w.sampler_state()] * 3, gens,
                                             thermodynamic_states=states[:3])
        return make

    *_, counters = _graph_run(bound, start(7), 5, True, monkeypatch)
    assert counters["integrator.graph_captures"] == 1
    k = bound._sweep_kernel
    x = torch.stack([w.positions] * 3)
    params = {n: torch.tensor([float(states[i % 3].global_params[n])
                               for i in range(9)],
                              dtype=x.dtype, device=cuda)
              for n in states[0].global_params}
    rep = torch.arange(9, device=cuda) % 3
    u, overflow = bound.energies_batch(x, None, rep, params)
    bound.check_sweep_overflow(overflow)
    assert torch.isfinite(u).all()
    assert k.batch_launches[("sweep_forces_alch", 9)] == 1
    junk = [torch.full((n,), 7, dtype=torch.int32, device=cuda)
            for n in (3, 9) for _ in range(256)]
    eager, l_e, b_e, _ = _graph_run(bound, start(21), 20, False, monkeypatch)
    graphed, l_g, b_g, c_g = _graph_run(bound, start(21), 20, True,
                                        monkeypatch)
    del junk
    _same_states(graphed, eager)
    assert l_g == l_e and b_g == b_e
    assert c_g["integrator.graph_steps"] == 20
    assert "integrator.graph_captures" not in c_g


@pytest.mark.cuda
def test_cuda_k2_counts_its_launches_on_the_device(cuda):
    """K2's kernels count their own launches on the card: the initial
    forces and a 4-step run, whose first step runs eagerly and whose other
    three replay the step's graph, read 5 launches of each kernel, by
    kernel and by batch size; a set count is an offset the next launches
    add to, and leaves the batch counts alone."""
    from openmmtools_tpu_torch.ops import sweep_nb as tsw

    w = _water(3.0, cuda)
    bound = BAOABIntegrator(temperature=300.0).bind(w.system)
    assert bound.sweep_mode and bound._graph_program
    k = bound._sweep_kernel
    k.launches.clear()
    k.batch_launches.clear()
    assert dict(k.launches) == {"sweep_bound": 0, "sweep_forces": 0}
    assert dict(k.batch_launches) == {}
    state = bound.initial_state(w.sampler_state(),
                                torch.Generator(device=cuda).manual_seed(1))
    state = bound.run(state, 4)
    assert [g.graph is not None for g in bound._graphs.values()] == [True]
    assert isinstance(k.launches, tsw.LaunchCounts)
    assert k.launches == {"sweep_bound": 5, "sweep_forces": 5}
    assert dict(k.batch_launches) == {("sweep_bound", 1): 5,
                                      ("sweep_forces", 1): 5}
    k.launches["sweep_bound"] = 2
    bound.run(state, 3)
    assert k.launches == {"sweep_bound": 5, "sweep_forces": 8}
    assert k.batch_launches[("sweep_bound", 1)] == 8


@pytest.mark.cuda
def test_cuda_step_graph_that_fails_to_capture_runs_eagerly(
        cuda, monkeypatch, caplog):
    """A step the graph cannot hold (one that turns the heat into float64,
    which ``copy_`` into its float32 buffer would cast): the capture raises
    ``CaptureError``, the program warns and runs the step eagerly, equal
    to the eager program to the bit, its signature stays eager on the next
    run, and the counters show steps and no replay."""
    w, states = _alchemical_ladder(3.0, cuda)
    bound = BAOABIntegrator(temperature=300.0, timestep=0.002,
                            collision_rate=1.0,
                            measure_heat=True).bind(w.system)
    step = bound._step

    def doubled_heat(s, skip):
        out = step(s, skip)
        return out.replace(heat=out.heat.to(torch.float64))

    monkeypatch.setattr(bound, "_step", doubled_heat)

    def start():
        gens = [torch.Generator(device=cuda).manual_seed(71 + i)
                for i in range(3)]
        return bound.initial_state_batch([w.sampler_state()] * 3, gens,
                                         thermodynamic_states=states)

    eager, l_e, b_e, c_e = _graph_run(bound, start, 10, False, monkeypatch)
    with caplog.at_level("WARNING"):
        graphed, l_g, b_g, c_g = _graph_run(bound, start, 10, True,
                                            monkeypatch)
    assert "failed to capture" in caplog.text
    assert list(bound._graphs.values()) == [None]
    _same_states(graphed, eager)
    assert l_g == l_e and b_g == b_e
    assert c_g == c_e and c_g["integrator.steps"] == 10
    again, *_, c_again = _graph_run(bound, start, 10, True, monkeypatch)
    _same_states(again, eager)
    assert c_again == c_e


# -- SETTLE (csrc/settle.cu): one thread a rigid water -----------------------

# two rigid water models in one spec: TIP3P's geometry and SPC/E's (other
# ra, rb, rc), O 15.9994 and H 1.008
WATER_MODELS = ((0.09572, 0.15139), (0.1, 0.16330))
SETTLE_EDGE = 6.223     # the main path's box: 20^3 waters, 8,000 in all


def _settle_case(layout, dtype, dev, seed=7):
    """8,000 rigid waters on the main path's 20^3 lattice, alternating the
    two models, each turned at random: (spec, masses, x_ref, x_new, v, the
    solute atoms). "contiguous" lays them out as (O, H, H) runs from atom
    0; "offset" puts 13 solute atoms first; "scattered" puts 5 solute atoms
    first and 7 between the two halves of the waters, and shuffles the
    waters' atoms so that no molecule is a run."""
    from openmmtools_tpu_torch.ops import constraints as tc
    from openmmtools_tpu_torch.system import Constraints

    rng = np.random.default_rng(seed)
    side = 20
    grid = (np.arange(side) + 0.5) * (SETTLE_EDGE / side)
    centres = np.stack(np.meshgrid(grid, grid, grid, indexing="ij"),
                       -1).reshape(-1, 3)
    n_w = centres.shape[0]
    xw, dist = [], []
    for k, c in enumerate(centres):
        d_oh, d_hh = WATER_MODELS[k % 2]
        half = 0.5 * d_hh
        h = np.sqrt(d_oh * d_oh - half * half)
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        tri = np.array([[0.0, 0.0, 0.0], [half, -h, 0.0], [-half, -h, 0.0]])
        xw.append(c + tri @ q.T)
        dist.append((d_oh, d_oh, d_hh))
    xw = np.concatenate(xw)
    mw = np.tile([15.9994, 1.008, 1.008], n_w)
    idx_w = np.concatenate([[[3 * k, 3 * k + 1], [3 * k, 3 * k + 2],
                             [3 * k + 1, 3 * k + 2]] for k in range(n_w)])
    before, between = {"contiguous": (0, 0), "offset": (13, 0),
                       "scattered": (5, 7)}[layout]
    n = 3 * n_w + before + between
    # where each water atom lands
    slots = np.arange(3 * n_w) + before
    slots[3 * n_w // 2:] += between
    if layout == "scattered":
        slots = rng.permutation(slots)
    solute = np.setdiff1d(np.arange(n), slots)
    x = rng.uniform(0.0, SETTLE_EDGE, size=(n, 3))
    x[slots] = xw
    m = np.full(n, 12.011)
    m[slots] = mw
    con = Constraints(index=torch.as_tensor(slots[idx_w], device=dev),
                      distance=torch.as_tensor(np.concatenate(dist),
                                               dtype=dtype, device=dev))
    masses = torch.as_tensor(m, dtype=dtype, device=dev)
    spec = tc.analyze_settle(con, masses)
    assert (spec.contig is None) == (layout == "scattered")
    v = rng.normal(scale=1.5, size=(n, 3))
    x_new = x + 0.002 * v + 0.001 * rng.normal(size=(n, 3))

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    return spec, masses, con, t(x), t(x_new), t(v), torch.as_tensor(
        solute, device=dev)


# Positions against the plain version: the kernel keeps the plain version's
# operations in absolute box coordinates (its centre of mass rounded
# operation by operation), so the two differ by the last rounding of a
# coordinate below 6.3 nm (4.8e-7 nm in float32, 8.9e-16 in float64) and a
# few roundings of the 0.1 nm frame: 1e-6 nm at float32, 1e-12 at float64.
SETTLE_TOL = {torch.float32: 1e-6, torch.float64: 1e-12}
# one rounding step of a coordinate at the box edge
SETTLE_ULP = {torch.float32: 2.0 ** -21, torch.float64: 2.0 ** -50}


def _bond_residual(x, con):
    i, j = (con.index[:, k].long() for k in (0, 1))
    r = torch.linalg.norm((x[..., i, :] - x[..., j, :]).double(), dim=-1)
    return float((r - con.distance.double()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", ["contiguous", "offset", "scattered"])
def test_cuda_settle_matches_plain(cuda, layout, dtype):
    """Each SETTLE kernel, one launch a call, against the plain version on
    the card: positions to ``SETTLE_TOL``, the bond residual no larger than
    the plain version's (to one rounding of a coordinate at the box edge:
    both residuals are the final rounding of each coordinate, and which
    maximum is larger by a rounding is chance), velocities to 1e-6 of their
    scale at float32 and 1e-13 at float64 with the same tangency, and the
    solute atoms untouched."""
    from openmmtools_tpu_torch.ops import constraints as tc

    spec, m, con, x, x_new, v, solute = _settle_case(layout, dtype, cuda)
    xp = tc.settle_positions(x_new, x, spec, m)
    xp_ref = tc.settle_positions_reference(x_new, x, spec, m)
    vp = tc.settle_velocities(xp_ref, v, spec, m)
    vp_ref = tc.settle_velocities_reference(xp_ref, v, spec, m)
    torch.cuda.synchronize()
    assert spec.launches == {"settle_positions": 1, "settle_velocities": 1}
    assert xp.dtype == dtype and vp.dtype == dtype
    dx = float((xp - xp_ref).abs().max())
    res, res_ref = _bond_residual(xp, con), _bond_residual(xp_ref, con)
    v_scale = float(vp_ref.abs().max())
    dv = float((vp - vp_ref).abs().max())
    i, j = (con.index[:, k].long() for k in (0, 1))

    def tangency(vv):
        return float(torch.sum((vv[i] - vv[j]).double()
                               * (xp_ref[i] - xp_ref[j]).double(),
                               dim=-1).abs().max())

    print(f"{layout} {dtype}: dx {dx:.3e}, residual {res:.3e} (plain "
          f"{res_ref:.3e}), dv/v {dv / v_scale:.3e}, tangency "
          f"{tangency(vp):.3e} (plain {tangency(vp_ref):.3e})")
    assert dx <= SETTLE_TOL[dtype]
    assert res <= res_ref + SETTLE_ULP[dtype]
    assert dv <= {torch.float32: 1e-6, torch.float64: 1e-13}[dtype] * v_scale
    assert tangency(vp) <= 2.0 * tangency(vp_ref) + SETTLE_ULP[dtype]
    assert torch.equal(xp[solute], x_new[solute])
    assert torch.equal(vp[solute], v[solute])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_settle_batch_equals_single_calls(cuda, dtype):
    """A batch of 9 (each replica moved by its own draw) in one launch of
    each kernel equals the nine single launches to the bit: nothing is
    summed across threads."""
    from openmmtools_tpu_torch.ops import constraints as tc

    spec, m, _, x, x_new, v, _ = _settle_case("scattered", dtype, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    kicks = torch.randn((9,) + tuple(x.shape), generator=gen, device=cuda,
                        dtype=dtype)
    xb, xnb, vb = x.expand(9, -1, -1), x_new + 0.002 * kicks, v + kicks
    xp = tc.settle_positions(xnb, xb, spec, m)
    vp = tc.settle_velocities(xp, vb, spec, m)
    assert spec.launches == {"settle_positions": 1, "settle_velocities": 1}
    for b in range(9):
        assert torch.equal(xp[b], tc.settle_positions(xnb[b], x, spec, m))
        assert torch.equal(vp[b], tc.settle_velocities(xp[b], vb[b], spec,
                                                       m))
    assert spec.launches == {"settle_positions": 10, "settle_velocities": 10}


@pytest.mark.cuda
def test_cuda_settle_replays_in_a_graph_as_launched(cuda):
    """Both kernels captured in a CUDA graph and replayed on new inputs
    give the eager launches' bits, and each replayed launch counts on the
    device (a capture runs nothing)."""
    from openmmtools_tpu_torch.ops import constraints as tc

    spec, m, _, x, x_new, v, _ = _settle_case("contiguous", torch.float32,
                                              cuda)
    bufs = [x.clone(), x_new.clone(), v.clone()]
    tc.settle_positions(bufs[1], bufs[0], spec, m)   # loads the library
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        xp = tc.settle_positions(bufs[1], bufs[0], spec, m)
        vp = tc.settle_velocities(xp, bufs[2], spec, m)
    for shift in (0.0, 1e-3):
        bufs[1].copy_(x_new + shift)
        bufs[2].copy_(v - shift)
        graph.replay()
        xe = tc.settle_positions(x_new + shift, x, spec, m)
        assert torch.equal(xp, xe)
        assert torch.equal(vp, tc.settle_velocities(xe, v - shift, spec, m))
    # 1 before the capture, 2 replayed and 2 eager; 2 + 2 velocities
    assert spec.launches == {"settle_positions": 5, "settle_velocities": 4}


@pytest.mark.cuda
def test_cuda_settle_refuses_other_types(cuda):
    from openmmtools_tpu_torch.ops import constraints as tc

    spec, m, _, x, x_new, _, _ = _settle_case("contiguous", torch.float32,
                                              cuda)
    with pytest.raises(TypeError, match="float32 or float64"):
        tc.settle_positions(x_new.half(), x.half(), spec, m)
    with pytest.raises(ValueError):
        tc.settle_positions(x_new, x.double(), spec, m)
    assert spec.launches["settle_positions"] == 0


@pytest.mark.cuda
def test_cuda_settle_kernel_in_the_water_step_graph(cuda, monkeypatch):
    """A rigid PME water box in sweep mode, 20 steps of BAOAB at B = 1:
    the replayed steps equal the eager steps to the bit; in both runs the
    kernels count on the device one launch for each of the 4 projections
    of a step and the run's closing one (81), the replays' launches among
    them, and the counters ``constraints.settle_kernel`` and
    ``constraints.settle`` agree."""
    w = _water(3.0, cuda)
    bound = BAOABIntegrator(temperature=300.0, timestep=0.002,
                            collision_rate=1.0).bind(w.system)
    assert bound.sweep_mode and bound._graph_program and bound._vproj_skip
    spec = bound.constraint_solver.settle

    def start():
        return bound.initial_state(
            w.sampler_state(), torch.Generator(device=cuda).manual_seed(9))

    def launched(graphs):
        before = dict(spec.launches)
        state, _, _, counters = _graph_run(bound, start, 20, graphs,
                                           monkeypatch)
        return state, {k: spec.launches[k] - before[k] for k in before}, \
            counters

    eager, l_e, c_e = launched(False)
    graphed, l_g, c_g = launched(True)
    _same_states(graphed, eager)
    assert l_e == l_g == {"settle_positions": 40, "settle_velocities": 41}
    assert c_e["constraints.settle"] == c_e["constraints.settle_kernel"] == 81
    assert c_g["constraints.settle"] == c_g["constraints.settle_kernel"] == 81
    assert c_g["integrator.graph_steps"] == 19
