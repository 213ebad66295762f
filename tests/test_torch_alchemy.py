"""The port's softcore functions, alchemical factory and dense
AlchemicalNonbondedTerm against the JAX package, at float64.

Both sides start from the same numpy inputs: the JAX reference system goes
through the JAX factory, and its numpy form (``port_system``) through the
port's factory. The port's alchemical system must equal the converted JAX
one (same fingerprint: every tensor and every static field), and its energy
must equal the JAX energy to rel 1e-10 over a grid of lambdas, forces (by
autograd on both sides) to 1e-10 of the force scale. Systems: the charged
LJ fluid (512 particles, q = +-0.2, PME) with region atoms 0-23, and small
water boxes (1.9 nm, cutoff 0.9 nm, 648 atoms): PME with the three PME
treatments, reaction field with both RF treatments, consistent and linear
exception scaling, two regions with and without their interaction, bonded
softening of a flexible water.
"""
import jax
import numpy as np
import pytest
import torch

from openmmtools_tpu import alchemy as jalch
from openmmtools_tpu.models import LennardJonesFluid as JaxLJ
from openmmtools_tpu.models import water as jwater
from openmmtools_tpu.ops import softcore as jsc
from openmmtools_tpu.system import make_energy_fn as jax_energy_fn
from openmmtools_tpu_torch import alchemy as talch
from openmmtools_tpu_torch.models import AlchemicalWaterBox
from openmmtools_tpu_torch.ops import softcore as tsc
from openmmtools_tpu_torch.system import make_energy_fn, value_and_grad

from test_torch_support import (
    fluid_with_exceptions,
    jax_f64,
    np64,
    port_system,
    two_regions,
)

REL = 1e-10
WATER = dict(box_edge=1.9, cutoff=0.9)
LAMBDA_GRID = [(1.0, 1.0), (0.55, 0.3), (0.0, 0.7), (0.2, 0.0), (0.0, 0.0)]


# ---------------------------------------------------------------------------
# softcore functions
# ---------------------------------------------------------------------------


def _pairs(seed=0, n=257):
    rng = np.random.default_rng(seed)
    return dict(r=rng.uniform(0.05, 1.2, n), sigma=rng.uniform(0.1, 0.4, n),
                eps=rng.uniform(0.0, 1.0, n), qq=rng.normal(size=n),
                lam=rng.uniform(0.0, 1.0, n))


@pytest.mark.parametrize("kw", [{}, dict(alpha=0.3, a=2.0, b=2.0),
                                dict(c=4.0, b=1.5), dict(a=1.5, alpha=0.7)])
def test_softcore_lj_matches_jax(kw):
    p = _pairs()
    r2 = p["r"] ** 2
    want = np.asarray(jsc.softcore_lj(r2, p["sigma"], p["eps"], p["lam"], **kw))
    got = np64(tsc.softcore_lj(torch.as_tensor(r2), torch.as_tensor(p["sigma"]),
                               torch.as_tensor(p["eps"]),
                               torch.as_tensor(p["lam"]), **kw))
    np.testing.assert_allclose(got, want, rtol=REL, atol=0)


@pytest.mark.parametrize("method,kw", [
    ("no_cutoff", {}), ("no_cutoff", dict(beta=0.5, e=2.0, f=2.0, d=2.0)),
    ("no_cutoff", dict(beta=0.3, f=3.0)),
    ("cutoff_periodic", dict(cutoff=1.2)),
    ("cutoff_periodic", dict(cutoff=1.2, shift_rf=False, beta=0.2)),
    ("pme", dict(ewald_alpha=3.1)), ("pme", dict(ewald_alpha=3.1, beta=0.4)),
])
def test_softcore_coulomb_matches_jax(method, kw):
    p = _pairs(1)
    args = (p["r"], p["qq"], p["sigma"], p["lam"])
    want = np.asarray(jsc.softcore_coulomb(*args, method=method, **kw))
    got = np64(tsc.softcore_coulomb(*map(torch.as_tensor, args),
                                    method=method, **kw))
    np.testing.assert_allclose(got, want, rtol=REL, atol=0)
    reff = np64(tsc.softcore_reff_electrostatics(
        torch.as_tensor(p["r"]), torch.as_tensor(p["sigma"]),
        torch.as_tensor(p["lam"]), beta=0.4))
    np.testing.assert_allclose(reff, np.asarray(
        jsc.softcore_reff_electrostatics(p["r"], p["sigma"], p["lam"],
                                         beta=0.4)), rtol=REL)


def test_softcore_pow_fast_paths():
    x = torch.tensor([0.3, 0.7], dtype=torch.float64)
    assert tsc._pow(x, 1) is x
    assert torch.equal(tsc._pow(x, 2.0), x * x)
    torch.testing.assert_close(tsc._pow(x, 1.5), x ** 1.5)


# ---------------------------------------------------------------------------
# factory and dense term
# ---------------------------------------------------------------------------


def _charged_fluid():
    return JaxLJ(nparticles=512, charge=0.2)


def _case(name):
    """(JAX reference system, positions, factory kwargs, regions function,
    parameter names)."""
    if name.startswith("fluid"):
        f = _charged_fluid()
        jsys, x = f.system, f.positions
        if "exceptions" in name:
            jsys = fluid_with_exceptions(jsys, x)
    elif name.startswith("rf"):
        w = jwater.WaterBox(nonbonded_method="cutoff_periodic", **WATER)
        jsys, x = w.system, w.positions
    else:
        w = jwater.FlexiblePMEWaterBox(**WATER)
        jsys, x = w.system, w.positions
    factory = {
        "fluid-direct-space": {}, "fluid-exact": dict(
            alchemical_pme_treatment="exact"),
        "fluid-coulomb": dict(alchemical_pme_treatment="coulomb"),
        "fluid-exceptions-linear": dict(alchemical_pme_treatment="coulomb"),
        "fluid-exceptions-consistent": dict(consistent_exceptions=True),
        "fluid-two-regions": {}, "fluid-two-regions-apart": {},
        "rf-switched": {}, "rf-shifted": dict(
            alchemical_rf_treatment="shifted"),
        "water-bonded": dict(disable_alchemical_dispersion_correction=True,
                             split_alchemical_forces=False),
    }[name]
    if name.startswith("fluid-two-regions"):
        def regions(module):
            return two_regions(module, name.endswith("regions"))
        names = ["lambda_sterics_a", "lambda_electrostatics_a",
                 "lambda_sterics_b", "lambda_electrostatics_b"]
    else:
        atoms = list(range(3)) if name.startswith(("rf", "water")) \
            else list(range(24))
        bonded = name == "water-bonded"

        def regions(module):
            return (module.AlchemicalRegion(
                alchemical_atoms=atoms, annihilate_sterics=True,
                alchemical_bonds=bonded or None,
                alchemical_angles=bonded or None), frozenset())
        names = ["lambda_sterics", "lambda_electrostatics"]
        if bonded:
            names += ["lambda_bonds", "lambda_angles"]
    return jsys, np.asarray(x, np.float64), factory, regions, names


CASES = ["fluid-direct-space", "fluid-exact", "fluid-coulomb",
         "fluid-exceptions-linear", "fluid-exceptions-consistent",
         "fluid-two-regions", "fluid-two-regions-apart", "rf-switched",
         "rf-shifted", "water-bonded"]


def _params(names, lams):
    # sterics and bonded lambdas take the first value, electrostatics the
    # second; region b's take them swapped
    out = {}
    for name in names:
        a, b = lams if not name.endswith("_b") else lams[::-1]
        out[name] = b if "electrostatics" in name else a
    return out


@pytest.mark.parametrize("name", CASES)
def test_factory_and_dense_energy_match_jax(name):
    jsys, x, factory_kw, regions, names = _case(name)
    jregions, jinter = regions(jalch)
    jalch_sys = jalch.AbsoluteAlchemicalFactory(
        **factory_kw).create_alchemical_system(jsys, jregions, jinter)
    tregions, tinter = regions(talch)
    talch_sys = talch.AbsoluteAlchemicalFactory(
        **factory_kw).create_alchemical_system(port_system(jsys), tregions,
                                               tinter)
    # the port's factory builds what the JAX factory builds
    assert talch_sys.fingerprint == port_system(jalch_sys).fingerprint
    assert ([type(t).__name__ for t in talch_sys.terms]
            == [type(t).__name__ for t in jalch_sys.terms])

    box = np.asarray(jsys.default_box, np.float64)
    j_u = jax.jit(jax.value_and_grad(jax_energy_fn(jax_f64(jalch_sys))))
    t_u = make_energy_fn(talch_sys)
    for lams in LAMBDA_GRID:
        params = _params(names, lams)
        u_j, g_j = j_u(x, box, params)
        tp = {k: torch.tensor(v, dtype=torch.float64)
              for k, v in params.items()}
        u_t, g_t = value_and_grad(lambda xx: t_u(xx, torch.as_tensor(box), tp),
                                  torch.as_tensor(x))
        assert abs(float(u_t) - float(u_j)) <= REL * abs(float(u_j)), lams
        g_j = np.asarray(g_j)
        assert np.abs(np64(g_t) - g_j).max() <= REL * np.abs(g_j).max(), lams


def test_alchemical_water_box_matches_jax_model():
    """AlchemicalWaterBox: the first water alchemical with the factory's
    defaults, the same system as the JAX model's."""
    jw = jwater.AlchemicalWaterBox(**WATER)
    tw = AlchemicalWaterBox(device="cpu", **WATER)
    assert (tw.system.to(dtype=torch.float64).fingerprint
            == port_system(jw.system).fingerprint)
    term = tw.system.terms[0]
    assert isinstance(term, talch.AlchemicalNonbondedTerm)
    assert term.force_group == 1 and term.method == "pme"
    assert term.annihilate_electrostatics == (True,)
    assert term.annihilate_sterics == (False,)
    assert not term.exact_electrostatics and not term.coulomb_pme_treatment
    assert torch.equal(term.region_id[:4],
                       torch.tensor([0, 0, 0, -1], dtype=torch.int32))


def test_sweep_lambdas_are_the_pair_lambdas():
    """The sweep kernel's class scalars hold, class by class, the pair
    lambdas of the dense term (lam^a, alpha (1-lam)^b, lam^d)."""
    jsys, x, _, regions, names = _case("fluid-two-regions")
    tregions, tinter = regions(talch)
    term = talch.AbsoluteAlchemicalFactory().create_alchemical_system(
        port_system(jsys), tregions, tinter).terms[0]
    term = term.replace(softcore_a=2.0, softcore_b=1.5, softcore_d=2.0)
    params = {k: torch.tensor(v, dtype=torch.float64)
              for k, v in _params(names, (0.55, 0.3)).items()}
    lam, lam_s_cls, scale = term.sweep_lambdas(params, torch.zeros(
        (), dtype=torch.float64))
    assert scale is None and lam.shape == (15,)
    ls, le = term._lambdas(params, lam)
    C = 5
    # one atom of each region code: env 24, region a 0, region b 12
    atom = {0: 24, 1: 0, 2: 12}
    classes = [(a, b) for a in range(3) for b in range(a, 3)][1:]
    rid = term.region_id
    for ci, (a, b) in enumerate(classes):
        i, j = torch.tensor([atom[a]]), torch.tensor([atom[b]])
        if a == b:
            j = torch.tensor([atom[a] + 1])   # another atom of the class
        ps = term._pair_lambdas(rid[i], rid[j], ls, term.annihilate_sterics)
        pe = term._pair_lambdas(rid[i], rid[j], le,
                                term.annihilate_electrostatics)
        assert torch.allclose(lam[ci], ps[0] ** 2)
        assert torch.allclose(lam_s_cls[ci], ps[0] ** 2)
        assert torch.allclose(lam[C + ci], 0.5 * (1 - ps[0]) ** 1.5)
        assert torch.allclose(lam[2 * C + ci], pe[0] ** 2)


def test_get_energy_components_sum_to_the_total():
    jsys, x, _, regions, names = _case("water-bonded")
    tregions, _ = regions(talch)
    system = talch.AbsoluteAlchemicalFactory(
        split_alchemical_forces=False).create_alchemical_system(
        port_system(jsys), tregions)
    params = {"lambda_bonds": 0.3, "lambda_sterics": 0.4}
    parts = talch.AbsoluteAlchemicalFactory.get_energy_components(
        system, torch.as_tensor(x), params=params)
    assert list(parts) == [f"{i}:{type(t).__name__}"
                           for i, t in enumerate(system.terms)]
    assert "2:AlchemicalHarmonicBondTerm" in parts
    total = system.energy(torch.as_tensor(x), params=params)
    assert abs(float(sum(parts.values())) - float(total)) <= 1e-12 * abs(
        float(total))


def test_factory_validation():
    jsys = _charged_fluid().system
    system = port_system(jsys)
    f = talch.AbsoluteAlchemicalFactory()
    with pytest.raises(talch.AlchemyError, match="overlap"):
        f.create_alchemical_system(system, [
            talch.AlchemicalRegion(alchemical_atoms=[0, 1], name="a"),
            talch.AlchemicalRegion(alchemical_atoms=[1, 2], name="b")])
    with pytest.raises(talch.AlchemyError, match="names"):
        f.create_alchemical_system(system, [
            talch.AlchemicalRegion(alchemical_atoms=[0]),
            talch.AlchemicalRegion(alchemical_atoms=[1])])
    with pytest.raises(talch.AlchemyError, match="out of range"):
        f.create_alchemical_system(
            system, talch.AlchemicalRegion(alchemical_atoms=[600]))
    with pytest.raises(talch.AlchemyError, match="defines no atoms"):
        f.create_alchemical_system(system, talch.AlchemicalRegion())
    with pytest.raises(talch.AlchemyError, match="one alchemical region"):
        talch.AbsoluteAlchemicalFactory(
            alchemical_pme_treatment="exact").create_alchemical_system(
            system, two_regions(talch, False)[0])
    with pytest.raises(talch.AlchemyError):
        talch.AbsoluteAlchemicalFactory(alchemical_pme_treatment="nope")
    with pytest.raises(talch.AlchemyError):
        talch.AbsoluteAlchemicalFactory(alchemical_rf_treatment="nope")
    assert issubclass(talch.AlchemyError, ValueError)


def test_unhandled_interacting_term_raises():
    from openmmtools_tpu_torch.system import CustomExternalTerm

    system = port_system(_charged_fluid().system)

    class PairTerm:            # an unknown all-particle interaction
        force_group = 0

    with pytest.raises(talch.AlchemyError, match="PairTerm"):
        talch.AbsoluteAlchemicalFactory().create_alchemical_system(
            system.replace(terms=system.terms + (PairTerm(),)),
            talch.AlchemicalRegion(alchemical_atoms=[0]))
    field = CustomExternalTerm(particles=torch.tensor([0, 1]),
                               global_defaults={}, expression="x")
    out = talch.AbsoluteAlchemicalFactory().create_alchemical_system(
        system.replace(terms=system.terms + (field,)),
        talch.AlchemicalRegion(alchemical_atoms=[0]))
    assert out.terms[-1] is field
