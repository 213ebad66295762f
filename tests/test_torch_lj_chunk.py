"""The LJ chunk kernel's step program and its plain chunk on the CPU.

The chunk kernel (csrc/dense_baoab.cu) walks a step program that the
wrapper passes as a table of uint32 words in the launch arguments. Here a
plain interpreter of that table, written from the kernel's word layout,
decodes what ``FusedSortedLangevin`` builds and holds it against
``_step_program``; the wrapper refuses a program past the table's size or
a segment past 16 tokens, and ``fits_chunk_table`` (which keeps such a
splitting on the integrator's generic program) says which fit; and on CPU
tensors both wrappers run the plain
chunk, ``fused_langevin_reference``, bit for bit with noise on. A two-sweep
splitting's plain chunk is held against the JAX package's
``FusedSortedLangevin`` in interpret mode at collision_rate 0, with the
tolerances of tests/test_pallas_baoab.py:195-202 (dx < 5e-4 modulo L, dv <
5e-3 of the velocity scale, U within 2e-4). The kernel itself is held
against the plain chunk on the card in tests/test_torch_cuda.py.
"""
import jax
import numpy as np
import pytest
import torch

from openmmtools_tpu.ops.pallas_baoab import FusedSortedLangevin as JaxK1
from openmmtools_tpu_torch.integrators import LangevinIntegrator
from openmmtools_tpu_torch.models import LennardJonesFluid
from openmmtools_tpu_torch.ops.fused_langevin import (
    FusedDenseBAOAB,
    FusedSortedLangevin,
    _step_program,
    draw_seed,
    fits_chunk_table,
    fused_langevin_reference,
)
from openmmtools_tpu_torch.states import SamplerState

from test_torch_support import minimized_fluid, np64, wrapped_distance

# 16 tokens before the sweep: the longest segment the table holds
LONG = "V R " + "O " * 14
SPLITTINGS = ["V R O R V", "O V R V O", "V R R O R R V", "V R V", "R V R V",
              LONG]
TOKEN = {0: "R", 1: "V", 2: "O"}


def _program(n, tokens, collision_rate=1.0, physics=None):
    p = physics or dict(cutoff=1.0, switch_width=None, sigma=0.3,
                        epsilon=1.0, mass=1.0)
    return FusedSortedLangevin(n, p["cutoff"], p["switch_width"], p["sigma"],
                               p["epsilon"], p["mass"], 0.002,
                               collision_rate, tokens=tuple(tokens.split()))


def _decode(words, n_items):
    """The kernel's reading of the table: 5 words an item, (kind, n_tok,
    tok_code, o_base, wrap); kind 1 a sweep, 0 a segment whose token k is
    bits 2k..2k+1 of tok_code."""
    assert len(words) == 5 * n_items
    items = []
    for k in range(n_items):
        kind, n_tok, code, o_base, wrap = words[5 * k:5 * k + 5]
        assert all(0 <= w < 2**32 for w in (kind, n_tok, code, o_base, wrap))
        if kind == 1:
            items.append(("sweep",))
        else:
            assert kind == 0
            toks = tuple(TOKEN[(code >> (2 * t)) & 3] for t in range(n_tok))
            items.append(("sub", toks, o_base, bool(wrap)))
    return items


@pytest.mark.parametrize("splitting", SPLITTINGS)
def test_table_decodes_to_the_step_program(splitting):
    prog = _program(256, splitting)
    assert _decode(prog.table, len(prog.program)) == _step_program(
        tuple(splitting.split()))
    sweeps = [i[0] for i in prog.program].count("sweep")
    assert sweeps == (2 if splitting == "R V R V" else 1)


@pytest.mark.parametrize("splitting, match", [
    ("R V " * 9, "at most 16"),          # 19 items
    ("V R " + "O " * 15, "more than 16 tokens"),
])
def test_wrapper_refuses_what_the_table_cannot_hold(splitting, match):
    with pytest.raises(ValueError, match=match):
        _program(256, splitting)


@pytest.mark.parametrize("splitting, fits", [
    ("V R O R V", True),
    (LONG, True),                        # 16 tokens before the sweep
    ("R V " * 9, False),                 # 19 items
    ("V R " + "O " * 15, False),         # 17 tokens before the sweep
])
def test_fit_predicate_matches_what_the_wrapper_takes(splitting, fits):
    """``fits_chunk_table`` is True exactly where the wrapper builds its
    table, so ``FusedPath.build`` never reaches a refusal."""
    assert fits_chunk_table(splitting.split()) is fits
    if fits:
        _program(256, splitting)
    else:
        with pytest.raises(ValueError):
            _program(256, splitting)


def test_long_splitting_runs_the_generic_program_in_sweep_mode():
    """What a CUDA LJ fluid does with a splitting the table cannot hold,
    here on the CPU: the generic program, in sweep mode, whose remainder
    (no bonded terms, exceptions or reciprocal space) does not depend on the
    positions (a zero gradient); 3 steps at gamma 0 follow the dense
    program."""
    fluid = LennardJonesFluid(nparticles=256, device="cpu")
    splitting = ("R V " * 9).strip()
    kw = dict(temperature=120.0, collision_rate=0.0, timestep=0.002,
              splitting=splitting)
    sweep = LangevinIntegrator(sweep="force", **kw).bind(fluid.system)
    dense = LangevinIntegrator(sweep=None, **kw).bind(fluid.system)
    assert sweep.sweep_mode and sweep.force_path.name != "K1"
    assert not dense.sweep_mode
    start = SamplerState(positions=fluid.positions,
                         velocities=torch.zeros_like(fluid.positions),
                         box_vectors=fluid.system.default_box)
    a = sweep.run(sweep.initial_state(start, torch.Generator()), 3)
    b = dense.run(dense.initial_state(start, torch.Generator()), 3)
    L = float(fluid.system.default_box[0, 0])
    assert wrapped_distance(a.positions, b.positions, L) < 1e-5
    assert abs(float(a.potentials[0] - b.potentials[0])) <= 2e-4 * abs(
        float(b.potentials[0]))


@pytest.mark.parametrize("splitting", ["V R O R V", "R V R V", "O V R V O"])
def test_run_on_cpu_is_the_plain_chunk(splitting):
    """With noise on, run on CPU tensors equals the plain chunk on the seed
    the generator gives, bit for bit, and launches nothing."""
    x, v, box, kT, p = minimized_fluid(n=200)
    prog = _program(200, splitting, 5.0, p)
    x, v, box = (torch.as_tensor(a) for a in (x, v, box))
    out = prog.run(x, v, box, kT, torch.Generator().manual_seed(8), 12)
    seed = draw_seed(torch.Generator().manual_seed(8))
    ref = fused_langevin_reference(prog, x, v, box, kT, seed, 12)
    for a, b in zip(out, ref):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    assert prog.launches == {"lj_forces": 0, "lj_chunk": 0}
    # the same seed through FusedDenseBAOAB's chunk for BAOAB
    if splitting == "V R O R V":
        dense = FusedDenseBAOAB(200, p["cutoff"], p["switch_width"],
                                p["sigma"], p["epsilon"], p["mass"], 0.002,
                                5.0, device="cpu")
        for a, b in zip(dense.chunk(x, v, box, kT, seed, 12), ref):
            assert torch.equal(a, b)
        assert dense.launches == {"dense_baoab": 0}


def test_two_sweep_plain_chunk_matches_jax_kernel():
    """"R V R V" (two force sweeps a step), gamma = 0, 25 steps from a
    FIRE-minimized start: the plain chunk against the JAX kernel."""
    x, v, box, kT, p = minimized_fluid()
    n = x.shape[0]
    L = float(box[0, 0])
    k = JaxK1(n, p["cutoff"], p["switch_width"], p["sigma"], p["epsilon"],
              p["mass"], timestep=0.002, collision_rate=0.0, interpret=True,
              tokens=("R", "V", "R", "V"))
    xk, vk, _, Uk, _ = k.run(x, v, box, kT, jax.random.PRNGKey(0), 25)
    prog = _program(n, "R V R V", 0.0, p)
    xo, vo, _, U = prog.run(torch.as_tensor(x), torch.as_tensor(v),
                            torch.as_tensor(box), kT, torch.Generator(), 25)
    v_scale = float(np.abs(np64(vk)).max())
    assert wrapped_distance(xo, xk, L) < 5e-4
    assert np.abs(np64(vo) - np64(vk)).max() < 5e-3 * v_scale
    assert abs(float(U) - float(Uk)) <= 2e-4 * abs(float(Uk))
    assert wrapped_distance(xo, x, L) > 1e-3
