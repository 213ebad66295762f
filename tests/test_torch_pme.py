"""Ewald reciprocal space: the port's ops/pme.py against the JAX package's,
at float64 on the CPU (rel 1e-10).

Held: the alpha/kmax heuristics; the real-basis structure factor and its
hand backward, including the cotangent of the k-space weight grid (through
which box derivatives flow); the complex Hermitian-half oracle; the
factorized and explicit-k-vector forms of ``EwaldReciprocalTerm``; the
split into ``energy_without_exclusions`` + ``exclusion_correction_of_r``.
Inputs are a small PME water box and numpy-seeded charges and phases.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmmtools_tpu.models import PMEWaterBox as JaxPMEWaterBox
from openmmtools_tpu.ops import pme as jpme
from openmmtools_tpu_torch.ops import pme as tpme
from openmmtools_tpu_torch.system import value_and_grad

from test_torch_support import jax_f64, np64, port_system

REL = 1e-10


def _close(a, b, rel=REL):
    a, b = np64(a), np.asarray(b, np.float64)
    return np.abs(a - b).max() <= rel * max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("cutoff,edge,tol", [(0.9, 1.9, 5e-4),
                                             (1.0, 6.223, 5e-4),
                                             (1.0, 2.5, 1e-5)])
def test_ewald_parameters_match_jax(cutoff, edge, tol):
    """(1.0, 6.223, 5e-4) is the slice's box: alpha 2.628/nm, kmax 14."""
    assert tpme.ewald_alpha(cutoff, tol) == jpme.ewald_alpha(cutoff, tol)
    alpha = tpme.ewald_alpha(cutoff, tol)
    assert tpme.ewald_kmax(alpha, edge, tol) == jpme.ewald_kmax(alpha, edge,
                                                                tol)
    np.testing.assert_array_equal(tpme._half_space_kvectors((3, 2, 4)),
                                  jpme._half_space_kvectors((3, 2, 4)))
    if edge == 6.223:
        assert round(alpha, 3) == 2.628 and tpme.ewald_kmax(alpha, edge) == 14


def _sf_inputs(seed=0, n=60, M=4):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=n)
    q -= q.mean()
    t = rng.uniform(0.0, 2 * np.pi, size=(3, n))
    w = np.abs(rng.normal(size=(M + 1, 2 * M + 1, 2 * M + 1)))
    w = 0.5 * (w + w[:, ::-1, :])      # even in ky and kz, as real grids are
    w = 0.5 * (w + w[:, :, ::-1])
    return q, t[0], t[1], t[2], w, M


@pytest.mark.parametrize("form", ["real", "complex"])
def test_structure_factor_sum_and_cotangents_match_jax(form):
    """W and its cotangents in (q, tx, ty, tz, w) against the JAX custom_vjp:
    the port's real form is a torch.autograd.Function with the hand backward,
    its complex form differentiates by autograd."""
    q, tx, ty, tz, w, M = _sf_inputs()
    jfn = (jpme._sf_weighted_sum_real if form == "real"
           else jpme._sf_weighted_sum)
    tfn = (tpme._sf_weighted_sum_real if form == "real"
           else tpme._sf_weighted_sum)
    W_j, grads_j = jax.value_and_grad(
        lambda *a: jfn(*a, M), argnums=(0, 1, 2, 3, 4))(
            *map(jnp.asarray, (q, tx, ty, tz, w)))
    args = [torch.as_tensor(a).requires_grad_(True) for a in (q, tx, ty, tz, w)]
    W_t = tfn(*args, M)
    grads_t = torch.autograd.grad(W_t, args)
    W_t = W_t.detach()
    assert abs(float(W_t) - float(W_j)) <= REL * abs(float(W_j))
    for gt, gj in zip(grads_t, grads_j):
        assert _close(gt, gj), (form, np.abs(np64(gt) - np.asarray(gj)).max())


def test_real_and_complex_forms_agree():
    q, tx, ty, tz, w, M = _sf_inputs(seed=4, M=6)
    args = [torch.as_tensor(a) for a in (q, tx, ty, tz, w)]
    real = float(tpme._sf_weighted_sum_real(*args, M))
    cplx = float(tpme._sf_weighted_sum(*args, M))
    assert abs(real - cplx) <= REL * abs(cplx)


@pytest.fixture(scope="module")
def water():
    """A 648-atom PME water box (kmax 5), float64 on both sides."""
    jw = JaxPMEWaterBox(box_edge=1.9, cutoff=0.9)
    jrec = jax_f64(jw.system.terms[1])
    trec = port_system(jw.system).terms[1]
    rng = np.random.default_rng(2)
    x = np.asarray(jw.positions, np.float64) + rng.normal(
        scale=0.01, size=(jw.system.n_particles, 3))
    return jrec, trec, x, np.asarray(jw.system.default_box, np.float64)


@pytest.mark.parametrize("kmax_form", [True, False])
def test_reciprocal_energy_and_forces_match_jax(water, kmax_form):
    """Reciprocal + self + exclusion energy and its forces, factorized
    (kmax) and explicit k-vector forms, both held to the JAX package's
    factorized form: its explicit form accumulates in float32
    (``preferred_element_type``) even at float64, the port's in the input's
    type, and both forms sum the same half k-space."""
    jrec, trec, x, box = water
    assert isinstance(trec, tpme.EwaldReciprocalTerm)
    assert (trec.alpha, trec.kmax) == (jrec.alpha, jrec.kmax)
    if not kmax_form:
        trec = trec.replace(kmax=None)
    u_j, g_j = jax.value_and_grad(lambda xx: jrec.energy(xx, box))(
        jnp.asarray(x))
    u_t, g_t = value_and_grad(
        lambda xx: trec.energy(xx, torch.as_tensor(box)), torch.as_tensor(x))
    assert abs(float(u_t) - float(u_j)) <= REL * abs(float(u_j))
    assert _close(g_t, g_j)


def test_box_derivative_matches_jax(water):
    """The weight-grid cotangent carries the box derivative: d E / d L."""
    jrec, trec, x, box = water
    dL_j = jax.grad(lambda b: jrec.energy(jnp.asarray(x), b))(jnp.asarray(box))
    bt = torch.as_tensor(box).requires_grad_(True)
    (dL_t,) = torch.autograd.grad(trec.energy(torch.as_tensor(x), bt), bt)
    assert _close(dL_t, dL_j)
    assert float(dL_t.abs().max()) > 0.0


def test_split_exclusion_hooks_reassemble_energy(water):
    """energy_without_exclusions + exclusion_correction_of_r(q, r) is the
    whole energy (the sweep path shares r with the exception add-back), and
    each half matches the JAX package's."""
    jrec, trec, x, box = water
    xt, bt = torch.as_tensor(x), torch.as_tensor(box)
    idx = trec.exclusion_index.long()
    d = xt[idx[:, 0]] - xt[idx[:, 1]]
    d = d - torch.diagonal(bt) * torch.round(d / torch.diagonal(bt))
    r = torch.sqrt(torch.sum(d * d, dim=1))
    q = trec.effective_charge()
    split = float(trec.energy_without_exclusions(xt, bt)
                  + trec.exclusion_correction_of_r(q, r))
    assert abs(split - float(trec.energy(xt, bt))) <= REL * abs(split)
    u_j = float(jrec.energy_without_exclusions(jnp.asarray(x), box))
    assert abs(float(trec.energy_without_exclusions(xt, bt)) - u_j) <= \
        REL * abs(u_j)
    assert float(trec.self_energy(q)) == pytest.approx(
        float(jrec.self_energy(jnp.asarray(np64(q)))), rel=REL)


def test_make_ewald_reciprocal_term_matches_jax():
    rng = np.random.default_rng(7)
    q = rng.normal(size=30)
    excl = np.stack([np.arange(0, 30, 3), np.arange(1, 30, 3)], 1)
    j = jpme.make_ewald_reciprocal_term(q, 2.2, 1.0, excl, tol=1e-5)
    t = tpme.make_ewald_reciprocal_term(q, 2.2, 1.0, excl, tol=1e-5,
                                        device="cpu")
    assert (t.alpha, t.kmax, t.charge_scale_param) == (
        j.alpha, j.kmax, j.charge_scale_param)
    for a, b in ((t.charge, j.charge), (t.kvecs, j.kvecs),
                 (t.exclusion_index, j.exclusion_index)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
