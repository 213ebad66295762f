"""The bounded-sweep direct space (ops/sweep_nb.py) and sweep mode, against
the JAX package.

* ``sort_for_sweep`` and ``build_exclusion_bitfield`` match the JAX package's
  exactly, duplicate and overflowing pairs included.
* The plain version of the kernel at float32 against the JAX kernel
  ``SweepNonbonded(interpret=True)`` on the same sorted inputs: forces within
  2e-4 of the force scale, energy within 2e-4 of the energy scale, the new
  bound equal; rebuild on and off; pme, ewald and reaction field; Coulomb
  switched or not. The energy scale is the sum of the absolute Coulomb pair
  energies (the energy of the same pairs with every charge made positive):
  the direct energy is a small difference of large pair terms, and float32
  sums of those terms differ by rounding of that sum, not of the difference.
  The JAX kernel's erfc is the Abramowitz-Stegun rational (|error| < 1.5e-7),
  the port's is exact.
* Sweep mode's energy and forces (``evaluate_sweep`` through
  ``initial_state``) at float64 against the JAX package's dense evaluation,
  to rel 1e-9.
Water boxes of 1.9 nm with a 0.9 nm cutoff (648 atoms): at that size the
rebuilt bound covers the whole ring, so the n_pad/2 shell and its half
weight take part.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmmtools_tpu.models import water as jwater
from openmmtools_tpu.ops import sweep_nb as jsw
from openmmtools_tpu.system import make_energy_force_fn as jax_ef
from openmmtools_tpu_torch.integrators import BAOABIntegrator, IntegratorError
from openmmtools_tpu_torch.ops import sweep_nb as tsw
from openmmtools_tpu_torch.states import SamplerState

from test_torch_support import jax_f64, np64, port_system

BOX = dict(box_edge=1.9, cutoff=0.9)
REL32 = 2e-4


@pytest.fixture(scope="module")
def water():
    jw = jwater.WaterBox(**BOX)
    n = jw.system.n_particles
    n_pad = -(-n // 128) * 128
    x = np.asarray(jw.positions, np.float32)
    box = np.asarray(jw.system.default_box, np.float32)
    return jw, n, n_pad, x, box


def _mask_rows(n_pad):
    return min(2048, max(32, (n_pad // 2 // 32) * 32)) // 32


def test_sort_matches_jax(water):
    jw, n, n_pad, x, box = water
    rng = np.random.default_rng(0)
    for xs in (x, (x + rng.normal(scale=0.3, size=x.shape)).astype(np.float32)):
        perm_j, inv_j = jsw.sort_for_sweep(jnp.asarray(xs), jnp.asarray(box),
                                           n_pad)
        perm_t, inv_t = tsw.sort_for_sweep(torch.as_tensor(xs),
                                           torch.as_tensor(box), n_pad)
        assert perm_t.dtype == inv_t.dtype == torch.int32
        np.testing.assert_array_equal(perm_t.numpy(), np.asarray(perm_j))
        np.testing.assert_array_equal(inv_t.numpy(), np.asarray(inv_j))


def _pairs_case(kind, water):
    jw, n, n_pad, _, _ = water
    pairs = np.asarray(jw.system.terms[0].exception_index)
    if kind == "water":
        return pairs, _mask_rows(n_pad)
    rng = np.random.default_rng(1)
    if kind == "duplicates":
        # each pair again, half of them flipped: a plain add would carry bits
        extra = pairs[rng.choice(len(pairs), 200, replace=False)]
        extra[::2] = extra[::2, ::-1]
        return np.concatenate([pairs, extra, pairs[:50]]), _mask_rows(n_pad)
    # "overflow": far pairs beyond a one-row (32-shell) coverage are dropped
    far = rng.choice(n, size=(300, 2))
    far = far[far[:, 0] != far[:, 1]]
    return np.concatenate([pairs, far]), 1


@pytest.mark.parametrize("kind", ["water", "duplicates", "overflow"])
def test_exclusion_bitfield_matches_jax(water, kind):
    jw, n, n_pad, x, box = water
    pairs, mask_rows = _pairs_case(kind, water)
    _, inv_j = jsw.sort_for_sweep(jnp.asarray(x), jnp.asarray(box), n_pad)
    _, inv_t = tsw.sort_for_sweep(torch.as_tensor(x), torch.as_tensor(box),
                                  n_pad)
    f_j, sep_j = jsw.build_exclusion_bitfield(pairs.astype(np.int32), inv_j,
                                              n_pad, mask_rows)
    f_t, sep_t = tsw.build_exclusion_bitfield(
        torch.as_tensor(pairs.astype(np.int32)), inv_t, n_pad, mask_rows)
    assert tuple(f_t.shape) == (mask_rows, n_pad) and f_t.dtype == torch.int32
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    assert int(sep_t) == int(sep_j)
    if kind == "overflow":
        assert int(sep_t) > 32 * mask_rows
    else:
        # one bit per distinct pair
        bits = sum(bin(int(v) & 0xFFFFFFFF).count("1")
                   for v in f_t.reshape(-1).tolist())
        assert bits == len(np.unique(np.sort(pairs, axis=1), axis=0))


def _sorted_inputs(water, dtype=np.float32):
    jw, n, n_pad, x, box = water
    t = jw.system.terms[0]
    perm, inv = jsw.sort_for_sweep(jnp.asarray(x), jnp.asarray(box), n_pad)
    perm = np.asarray(perm)
    L = np.diagonal(box)
    y = (x - L * np.floor(x / L))[perm]
    y_pad = np.concatenate([y, np.full((n_pad - n, 3), 1e6)]).astype(dtype)
    par = np.stack([np.asarray(t.sigma), np.sqrt(np.asarray(t.epsilon)),
                    np.asarray(t.charge)], 1)[perm]
    par_pad = np.concatenate([par, np.zeros((n_pad - n, 3))]).astype(dtype)
    excl, _ = jsw.build_exclusion_bitfield(t.exception_index, inv, n_pad,
                                           _mask_rows(n_pad))
    return t, y_pad, par_pad, np.array(excl)


KERNEL_CASES = [("pme", False, True), ("pme", False, False),
                ("ewald", False, True), ("cutoff_periodic", False, True),
                ("cutoff_periodic", False, False), ("pme", True, True)]


@pytest.mark.parametrize("method,switch_coulomb,rebuild", KERNEL_CASES)
def test_plain_kernel_matches_jax_interpret(water, method, switch_coulomb,
                                            rebuild):
    jw, n, n_pad, x, box = water
    t, y, par, excl = _sorted_inputs(water)
    kw = dict(switch_width=0.15, switch_coulomb=switch_coulomb,
              ewald_alpha=None if method == "cutoff_periodic"
              else t.ewald_alpha, mask_shells=32 * _mask_rows(n_pad))
    jk = jsw.SweepNonbonded(n, method, BOX["cutoff"], interpret=True, **kw)
    tk = tsw.SweepNonbonded(n, method, BOX["cutoff"], **kw)
    bound = 20
    f_j, u_j, nb_j = jk.forces(jnp.asarray(y), jnp.asarray(par),
                               jnp.asarray(box), jnp.asarray(excl),
                               jnp.asarray(rebuild), jnp.int32(bound))
    args = (torch.as_tensor(box), torch.as_tensor(excl),
            torch.tensor(rebuild), torch.tensor(bound, dtype=torch.int32))
    f_t, u_t, nb_t = tk.forces(torch.as_tensor(y), torch.as_tensor(par), *args)
    assert f_t.dtype == torch.float32 and tuple(f_t.shape) == (n_pad, 3)
    assert int(nb_t) == int(nb_j) == (tk.n_blocks if rebuild else bound)
    f_j = np.asarray(f_j)
    assert np.abs(np64(f_t) - f_j).max() <= REL32 * np.abs(f_j).max()
    assert not np.any(np64(f_t)[n:])           # pad slots feel nothing
    # energy scale: the same pairs with every charge made positive, float64
    par_abs = torch.as_tensor(par).double()
    par_abs[:, 2] = par_abs[:, 2].abs()
    _, u_scale, _ = tk.forces(torch.as_tensor(y).double(), par_abs, *args)
    assert abs(float(u_t) - float(u_j)) <= REL32 * float(u_scale)
    assert tk.launches == {"sweep_bound": 0, "sweep_forces": 0}


def test_plain_kernel_zero_bound_is_empty(water):
    _, n, n_pad, _, box = water
    t, y, par, excl = _sorted_inputs(water)
    tk = tsw.SweepNonbonded(n, "pme", BOX["cutoff"], ewald_alpha=t.ewald_alpha,
                            mask_shells=32 * _mask_rows(n_pad))
    f, u, nb = tk.forces(torch.as_tensor(y), torch.as_tensor(par),
                         torch.as_tensor(box), torch.as_tensor(excl),
                         torch.tensor(False), torch.tensor(0, dtype=torch.int32))
    assert int(nb) == 0 and float(u) == 0.0 and not torch.any(f)


def test_sorted_inputs_match_the_kernel_layout(water):
    """``sorted_inputs`` builds the (3, n_pad) inputs the wrappers take: the
    TPU kernel's sorted rows transposed, pad slots at 1e6 with zero
    parameters, and the JAX package's bitfield."""
    jw, n, n_pad, x, box = water
    _, y, par, excl = _sorted_inputs(water)
    term = port_system(jw.system).terms[0]
    tk = tsw.SweepNonbonded(n, "pme", BOX["cutoff"],
                            ewald_alpha=term.ewald_alpha,
                            mask_shells=32 * _mask_rows(n_pad))
    xT, par_t, excl_t, L, max_sep = tsw.sorted_inputs(
        term, torch.as_tensor(x), torch.as_tensor(box), tk)
    assert xT.dtype == par_t.dtype == L.dtype == torch.float32
    assert xT.is_contiguous() and par_t.is_contiguous()
    np.testing.assert_array_equal(xT.numpy(), y.T)
    np.testing.assert_allclose(par_t.numpy(), par.T, rtol=1e-7, atol=0)
    assert not np.any(par_t.numpy()[:, n:])
    np.testing.assert_array_equal(excl_t.numpy(), excl)
    np.testing.assert_array_equal(L.numpy(), np.diagonal(box))
    assert 0 < int(max_sep) <= tk.mask_shells


def test_plain_subclass_is_the_wrappers_on_cpu(water):
    """``PlainSweepNonbonded.like`` copies every setting and gives what the
    wrappers give on CPU tensors, without counting a launch."""
    jw, n, n_pad, x, box = water
    term = port_system(jw.system).terms[0]
    tk = tsw.SweepNonbonded(n, "cutoff_periodic", BOX["cutoff"],
                            switch_width=0.15, dielectric=70.0,
                            shift_rf=False, switch_coulomb=True,
                            shell_block=4, skin=0.12,
                            mask_shells=32 * _mask_rows(n_pad))
    plain = tsw.PlainSweepNonbonded.like(tk)
    assert plain.physics() == tk.physics()
    assert (plain.skin, plain.mask_shells, plain.n_pad) == (
        tk.skin, tk.mask_shells, tk.n_pad)
    args = tsw.sorted_inputs(term, torch.as_tensor(x), torch.as_tensor(box),
                             tk)[:4]
    flag, zero = torch.tensor(True), torch.tensor(0, dtype=torch.int32)
    for a, b in zip(tk.evaluate(*args, flag, zero),
                    plain.evaluate(*args, flag, zero)):
        assert torch.equal(a, b)
    assert tk.launches == plain.launches == {"sweep_bound": 0,
                                             "sweep_forces": 0}


def test_wrapper_refuses_devices_without_a_kernel():
    tk = tsw.SweepNonbonded(256, "pme", 0.9, ewald_alpha=3.0)
    x = torch.zeros((3, 256), device="meta")
    with pytest.raises(ValueError, match="no sweep kernel"):
        tk.measure_bound(x, x[:, 0], torch.tensor(True), torch.tensor(0))


def _scaled(system):
    """The system with global charge/LJ scale parameters on its
    NonbondedTerm (and the reciprocal term's charge scale)."""
    terms = []
    for t in system.terms:
        if type(t).__name__ == "NonbondedTerm":
            t = t.replace(charge_scale_param="qscale", lj_scale_param="ljscale")
        elif type(t).__name__ == "EwaldReciprocalTerm":
            t = t.replace(charge_scale_param="qscale")
        terms.append(t)
    return system.replace(terms=tuple(terms))


EVAL_CASES = ["PMEWaterBox", "FlexiblePMEWaterBox",
              "FlexibleReactionFieldWaterBox", "ewald-spce", "scaled"]


@pytest.mark.parametrize("case", EVAL_CASES)
def test_sweep_eval_matches_jax_dense(case):
    """Sweep mode's (U, F) at float64 against the dense JAX evaluation, rel
    1e-9: the kernel's pairs, the fused valence gather, the exception
    add-back with the reciprocal exclusion correction from the same r, the
    reciprocal space and the dispersion tail."""
    params = {}
    if case == "ewald-spce":
        jw = jwater.WaterBox(model="spce", nonbonded_method="ewald", **BOX)
    elif case == "scaled":
        jw = jwater.FlexiblePMEWaterBox(**BOX)
        params = {"qscale": 0.9, "ljscale": 0.7}
    else:
        jw = getattr(jwater, case)(**BOX)
    jsys = _scaled(jw.system) if params else jw.system
    n = jsys.n_particles
    x = np.asarray(jw.positions, np.float64) + np.random.default_rng(
        4).normal(scale=2e-3, size=(n, 3))
    box = np.asarray(jsys.default_box, np.float64)
    u_j, f_j = jax.jit(jax_ef(jax_f64(jsys)))(x, box, params)

    system = port_system(jsys)
    bound = BAOABIntegrator(temperature=300.0, sweep="force").bind(system)
    assert bound.sweep_mode and bound.force_path.name != "K1"
    if case != "FlexibleReactionFieldWaterBox":
        # the fused exclusion correction
        assert bound.force_path.recip is not None
    state = bound.initial_state(
        SamplerState(positions=torch.as_tensor(x),
                     velocities=torch.zeros((n, 3), dtype=torch.float64),
                     box_vectors=torch.as_tensor(box)),
        torch.Generator(), global_params=params)
    u_t, f_t = float(state.potentials[0]), np64(state.forces[0])
    assert abs(u_t - float(u_j)) <= 1e-9 * abs(float(u_j))
    f_j = np.asarray(f_j)
    assert np.abs(f_t - f_j).max() <= 1e-9 * np.abs(f_j).max()
    assert int(state.sweep_nblk) == bound._sweep_kernel.n_blocks
    assert not bool(state.sweep_overflow)


def test_sweep_eval_reads_the_scale_parameters_at_each_step():
    """The sorted parameters are cached at each re-sort without the global
    scale parameters, which fold in at every evaluation: new values in the
    state change the next energy exactly as a fresh start with them does."""
    jw = jwater.FlexiblePMEWaterBox(**BOX)
    system = port_system(_scaled(jw.system))
    n = system.n_particles
    x = torch.as_tensor(np.asarray(jw.positions, np.float64))
    sampler = SamplerState(positions=x,
                           velocities=torch.zeros((n, 3), dtype=torch.float64),
                           box_vectors=system.default_box)
    bound = BAOABIntegrator(temperature=300.0, sweep="force").bind(system)
    before = {"qscale": 0.9, "ljscale": 0.7}
    after = {"qscale": 0.5, "ljscale": 0.25}
    state = bound.initial_state(sampler, torch.Generator(),
                                global_params=before)
    params = {k: torch.as_tensor(v, dtype=torch.float64)
              for k, v in after.items()}
    u, f, _ = bound.force_path.evaluate_sweep(
        x, state.box, params, bound.force_path.context(state))
    fresh = bound.initial_state(sampler, torch.Generator(),
                                global_params=after)
    assert abs(float(u - fresh.potentials[0])) <= 1e-12 * abs(float(u))
    assert torch.allclose(f, fresh.forces[0], rtol=0, atol=1e-9)
    assert abs(float(u - state.potentials[0])) > 1.0


def test_sweep_mode_policy():
    """"auto" engages only on a CUDA system (never here); "force" engages on
    the CPU with the plain versions; None, a cutoff past half the box and a
    non-periodic method keep the generic program."""
    from openmmtools_tpu_torch.models import WaterBox, WaterCluster

    system = WaterBox(device="cpu", **BOX).system

    def mode(sweep, s=system):
        return BAOABIntegrator(temperature=300.0, sweep=sweep).bind(s).sweep_mode

    assert not mode("auto") and mode("force") and mode("interpret")
    assert not mode(None)
    big_cut = WaterBox(device="cpu", box_edge=2.0, cutoff=0.99).system
    half = big_cut.replace(default_box=big_cut.default_box * 0.9)
    assert not mode("force", half)
    assert not mode("force", WaterCluster(device="cpu").system)


def test_run_raises_while_the_overflow_flag_is_set():
    from openmmtools_tpu_torch.models import WaterBox

    w = WaterBox(device="cpu", **BOX)
    bound = BAOABIntegrator(temperature=300.0, collision_rate=0.0,
                            sweep="force").bind(w.system)
    state = bound.initial_state(w.sampler_state(), torch.Generator())
    state = state.replace(sweep_overflow=torch.tensor(True))
    with pytest.raises(IntegratorError, match="overflow"):
        bound.run(state, 1)
