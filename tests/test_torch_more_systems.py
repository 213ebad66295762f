"""The batch-2 test systems (``models/more_systems.py``) against the JAX
package's: the same positions and parameters, bit for bit, the same
energy and forces at float64, the same degrees of freedom and constraints;
the double-well chain's bond-count rules.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmmtools_tpu.models as jmodels
import openmmtools_tpu_torch.models as tmodels
from openmmtools_tpu_torch.models import more_systems
from openmmtools_tpu_torch.system import make_energy_fn, value_and_grad

from test_torch_support import jax_f64, np64, port_system

SYSTEMS = [
    "SodiumChlorideCrystal", "DiatomicFluid", "UnconstrainedDiatomicFluid",
    "ConstrainedDiatomicFluid", "DipolarFluid", "UnconstrainedDipolarFluid",
    "ConstrainedDipolarFluid", "ConstraintCoupledHarmonicOscillator",
    "LennardJonesGrid", "CustomLennardJonesFluidMixture",
    "DoubleWellDimer_WCAFluid", "DoubleWellChain_WCAFluid",
    "CustomGBForceSystem",
]
# small sizes of the larger defaults (the defaults are swept on the card)
SMALL = {
    "DiatomicFluid": dict(nmolecules=60),
    "UnconstrainedDiatomicFluid": dict(nmolecules=60),
    "ConstrainedDiatomicFluid": dict(nmolecules=60),
    "DipolarFluid": dict(nmolecules=60),
    "UnconstrainedDipolarFluid": dict(nmolecules=60),
    "ConstrainedDipolarFluid": dict(nmolecules=60),
    "LennardJonesGrid": dict(nx=5, ny=4, nz=6),
    "CustomLennardJonesFluidMixture": dict(nparticles=200,
                                           epsilon_scale=1.7),
    "DoubleWellDimer_WCAFluid": dict(ndimers=5, nparticles=64),
    "DoubleWellChain_WCAFluid": dict(nchained=9, nparticles=64),
    "CustomGBForceSystem": dict(n_molecules=20),
}


def _both(name, **kw):
    return (getattr(jmodels, name)(**kw),
            getattr(tmodels, name)(device="cpu", **kw))


def test_the_ported_systems_are_the_catalogs_batch_2():
    """The port's more_systems holds exactly the JAX module's systems: the
    batch-2 systems that read no Amber file (held here) and the prmtop
    systems (held in ``test_torch_prmtop_systems.py``)."""
    import openmmtools_tpu.models.more_systems as jmore

    def of_module(names, models, module):
        return sorted(n for n in names
                      if getattr(models, n).__module__ == module.__name__)

    ported = of_module(tmodels.get_available_testsystems(), tmodels,
                       more_systems)
    assert ported == of_module(jmodels.get_available_testsystems(), jmodels,
                               jmore)
    assert set(SYSTEMS) <= set(ported)
    assert all(issubclass(getattr(tmodels, n), more_systems._PrmtopSystem)
               or n in ("MolecularIdealGas", "MethanolBox")
               for n in set(ported) - set(SYSTEMS))


@pytest.mark.parametrize("name", SYSTEMS)
def test_system_matches_jax(name):
    kw = SMALL.get(name, {})
    js, ps = _both(name, **kw)
    np.testing.assert_array_equal(ps.positions.numpy(),
                                  np.asarray(js.positions))
    assert getattr(ps, "ndof", None) == getattr(js, "ndof", None)
    assert (ps.system.constraints.n_constraints
            == js.system.constraints.n_constraints)
    assert [type(t).__name__ for t in ps.system.terms] == [
        type(t).__name__ for t in js.system.terms]
    # the converter builds the port's own system from the JAX leaves
    assert port_system(js.system, dtype=None).fingerprint == \
        ps.system.fingerprint

    x = np.asarray(js.positions, np.float64)
    jsys = jax_f64(js.system)
    u_jax, g_jax = jax.value_and_grad(
        lambda xx: jsys.energy(xx, jsys.default_box))(jnp.asarray(x))
    psys = ps.system.to(dtype=torch.float64)
    u_fn = make_energy_fn(psys)
    u_port, g_port = value_and_grad(
        lambda xx: u_fn(xx, psys.default_box), torch.as_tensor(x))
    assert abs(float(u_port) - float(u_jax)) <= 1e-10 * abs(float(u_jax))
    g_jax = np.asarray(g_jax)
    assert np.abs(np64(g_port) - g_jax).max() <= 1e-10 * np.abs(g_jax).max()


def test_default_sizes_match_jax():
    """The default constructors give the JAX package's sizes and
    positions (the parity sweep builds them so)."""
    for name in SYSTEMS:
        js, ps = _both(name)
        assert ps.system.n_particles == js.system.n_particles, name
        np.testing.assert_array_equal(ps.positions.numpy(),
                                      np.asarray(js.positions))


def test_double_well_chain_bond_counts():
    """nchained = 0 means 1 (a bare WCA fluid), a chain may span every
    particle (nparticles - 1 bonds, beyond the dimer fluid's nparticles //
    2), a negative count raises."""
    def bonds(ts):
        terms = [t for t in ts.system.terms
                 if isinstance(t, more_systems.DoubleWellBondTerm)]
        return 0 if not terms else terms[0].index.shape[0]

    chain = more_systems.DoubleWellChain_WCAFluid
    assert bonds(chain(nchained=0, nparticles=16, device="cpu")) == 0
    assert bonds(chain(nchained=1, nparticles=16, device="cpu")) == 0
    full = chain(nchained=16, nparticles=16, device="cpu")
    assert bonds(full) == 15
    idx = full.system.terms[-1].index.numpy()
    np.testing.assert_array_equal(idx, np.stack([np.arange(15),
                                                 np.arange(1, 16)], 1))
    with pytest.raises(ValueError):
        chain(nchained=-1, nparticles=16, device="cpu")
    with pytest.raises(ValueError):
        chain(nchained=17, nparticles=16, device="cpu")
    dimer = more_systems.DoubleWellDimer_WCAFluid
    assert bonds(dimer(ndimers=8, nparticles=16, device="cpu")) == 8
    with pytest.raises(ValueError):
        dimer(ndimers=9, nparticles=16, device="cpu")
    with pytest.raises(ValueError):
        jmodels.DoubleWellChain_WCAFluid(nchained=-1, nparticles=16)
