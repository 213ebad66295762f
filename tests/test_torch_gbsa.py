"""GBSA-OBC (``ops/gbsa.py``) against the JAX package's term at float64:
OBC II, OBC I, HCT, with and without the surface term, and alchemically
softened at g = 0, 0.5 and 1; the factory's GB branch on
CustomGBForceSystem.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmmtools_tpu import alchemy as jalch
from openmmtools_tpu.models import CustomGBForceSystem as JaxGBSystem
from openmmtools_tpu.ops import gbsa as jgbsa
from openmmtools_tpu_torch import alchemy as talch
from openmmtools_tpu_torch.models import CustomGBForceSystem
from openmmtools_tpu_torch.ops import gbsa as tgbsa
from openmmtools_tpu_torch.system import value_and_grad

from test_torch_support import jax_f64, port_system

N = 24
VARIANTS = {
    "obc2": {},
    "obc1": dict(obc_alpha=jgbsa.OBC1[0], obc_beta=jgbsa.OBC1[1],
                 obc_gamma=jgbsa.OBC1[2]),
    "hct": dict(hct=True),
    "obc2-no-surface": dict(surface_area_energy=False),
    "hct-no-surface": dict(hct=True, surface_area_energy=False),
}


def _inputs(seed=4):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.2, (N, 3))
    q = rng.uniform(-0.5, 0.5, N)
    radius = rng.uniform(0.1, 0.2, N)
    scale = rng.uniform(0.5, 0.9, N)
    alch = (np.arange(N) < 6).astype(np.float64)
    return x, q, radius, scale, alch


def _terms(variant, lambda_name=None):
    x, q, radius, scale, alch = _inputs()
    kw = dict(VARIANTS[variant], solvent_dielectric=80.0)
    jt = jgbsa.GBSAOBCTerm(
        charge=jnp.asarray(q), radius=jnp.asarray(radius),
        scale=jnp.asarray(scale), lambda_name=lambda_name,
        alchemical=None if lambda_name is None else jnp.asarray(alch), **kw)
    tt = tgbsa.GBSAOBCTerm(
        charge=torch.as_tensor(q), radius=torch.as_tensor(radius),
        scale=torch.as_tensor(scale), lambda_name=lambda_name,
        alchemical=None if lambda_name is None else torch.as_tensor(alch),
        **kw)
    return x, jt, tt


def _jax_uf(term, x, params):
    u, g = jax.value_and_grad(lambda xx: term.energy(xx, None, params))(
        jnp.asarray(x))
    return float(u), -np.asarray(g)


def _port_uf(term, x, params):
    u, g = value_and_grad(lambda xx: term.energy(xx, None, params),
                          torch.as_tensor(x))
    return float(u), -g.numpy()


def _assert_close(a, b):
    (u_a, f_a), (u_b, f_b) = a, b
    assert abs(u_a - u_b) <= 1e-10 * abs(u_b), (u_a, u_b)
    assert np.abs(f_a - f_b).max() <= 1e-10 * np.abs(f_b).max()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_gbsa_matches_jax(variant):
    x, jt, tt = _terms(variant)
    _assert_close(_port_uf(tt, x, None), _jax_uf(jt, x, None))


@pytest.mark.parametrize("lam", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("variant", ["obc2", "hct-no-surface"])
def test_alchemical_gbsa_matches_jax(variant, lam):
    x, jt, tt = _terms(variant, lambda_name="lambda_electrostatics")
    _assert_close(
        _port_uf(tt, x, {"lambda_electrostatics":
                         torch.tensor(lam, dtype=torch.float64)}),
        _jax_uf(jt, x, {"lambda_electrostatics": jnp.float64(lam)}))


def test_self_and_surface_terms_scale_linearly_in_g():
    """A lone alchemical atom: its Born self energy and surface term scale
    by g, not g^2."""
    x, q, radius, scale, _ = _inputs()
    term = tgbsa.GBSAOBCTerm(
        charge=torch.as_tensor(q[:1]), radius=torch.as_tensor(radius[:1]),
        scale=torch.as_tensor(scale[:1]), lambda_name="lam",
        alchemical=torch.ones(1, dtype=torch.float64))
    xx = torch.as_tensor(x[:1])
    u1 = float(term.energy(xx, None, {"lam": torch.tensor(1.0,
                                                          dtype=torch.float64)}))
    uh = float(term.energy(xx, None, {"lam": torch.tensor(0.5,
                                                          dtype=torch.float64)}))
    assert uh == pytest.approx(0.5 * u1, rel=1e-12)


@pytest.mark.parametrize("variant", ["obc2", "hct"])
def test_forces_finite_at_coincident_positions(variant):
    """The double where keeps the diagonal (and a coincident pair) out of
    the gradient's NaNs."""
    x, jt, tt = _terms(variant)
    x = x.copy()
    x[1] = x[0]
    u, f = _port_uf(tt, x, None)
    assert np.isfinite(u) and np.isfinite(f).all()
    _assert_close((u, f), _jax_uf(jt, x, None))


def test_custom_gb_system_factory_matches_jax():
    """The factory keys the GB branch by isinstance on the port's term and
    softens it as the JAX factory does: the alchemical system's energy at
    lambda_electrostatics 0, 0.5 and 1 at float64 (the JAX package's
    tests/test_alchemy.py CustomGBForceSystem case)."""
    jts = JaxGBSystem(n_molecules=8)
    pts = CustomGBForceSystem(n_molecules=8, device="cpu")
    atoms = list(range(4))
    j_alch = jalch.AbsoluteAlchemicalFactory().create_alchemical_system(
        jts.system, jalch.AlchemicalRegion(alchemical_atoms=atoms))
    p_alch = talch.AbsoluteAlchemicalFactory().create_alchemical_system(
        pts.system, talch.AlchemicalRegion(alchemical_atoms=atoms))
    gb = [t for t in p_alch.terms if isinstance(t, tgbsa.GBSAOBCTerm)]
    assert len(gb) == 1 and gb[0].alchemical is not None
    assert gb[0].lambda_name == "lambda_electrostatics"
    converted = port_system(j_alch)
    assert converted.fingerprint == p_alch.to(dtype=torch.float64).fingerprint
    p64 = p_alch.to(dtype=torch.float64)
    jsys = jax_f64(j_alch)
    x = np.asarray(jts.positions, np.float64)
    for lam in (0.0, 0.5, 1.0):
        params = {"lambda_electrostatics": lam, "lambda_sterics": 1.0}
        u_jax = float(jsys.energy(jnp.asarray(x), jsys.default_box,
                                  {k: jnp.float64(v)
                                   for k, v in params.items()}))
        u_port = float(p64.energy(torch.as_tensor(x), p64.default_box,
                                  {k: torch.tensor(v, dtype=torch.float64)
                                   for k, v in params.items()}))
        assert abs(u_port - u_jax) <= 1e-10 * abs(u_jax), (lam, u_port,
                                                           u_jax)
