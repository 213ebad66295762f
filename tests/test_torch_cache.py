"""The port's cache.py against the JAX package's, on the CPU.

* ``LRUCache``: the JAX package's own cases (capacity, time-to-live counted
  in accesses, refresh on read, the setters), and a seeded random sequence
  of writes, reads, pops and setter changes applied to both packages' caches
  with the same keys after every operation.
* ``ContextCache``: states of one system and ensemble share a bound
  integrator; another system, ensemble or integrator setting binds its own;
  the key is the systems' content, so two restrained systems of equal
  shapes and different reference positions never share one (the JAX
  package's structural key would); ``get_context`` with no integrator
  returns a cached context of the state's system, else binds the default
  ``LangevinIntegrator`` at the state's temperature with the cache's
  keyword arguments (``sweep="force"`` engages sweep mode here);
  ``DummyContextCache`` keeps nothing; the global cache exists.
"""
import numpy as np
import pytest
import torch

from openmmtools_tpu import cache as jcache
from openmmtools_tpu_torch import cache as tcache
from openmmtools_tpu_torch.forces import restrain_atoms
from openmmtools_tpu_torch.integrators import (
    BAOABIntegrator,
    LangevinIntegrator,
)
from openmmtools_tpu_torch.models import (
    HarmonicOscillator,
    LennardJonesPair,
    PMEWaterBox,
)
from openmmtools_tpu_torch.states import ThermodynamicState


def test_lru_capacity():
    c = tcache.LRUCache(capacity=2)
    c["a"] = 1
    c["b"] = 2
    c["c"] = 3
    assert "a" not in c and "b" in c and "c" in c
    _ = c["b"]
    c["d"] = 4   # evicts c (b was read)
    assert "c" not in c and "b" in c
    c.capacity = 1
    assert list(c.keys()) == ["d"]


def test_lru_ttl_and_refresh():
    c = tcache.LRUCache(time_to_live=3)
    c["a"] = 1
    c["b"] = 2      # access 2: a expires at 4
    _ = c["a"]      # access 3: a now expires at 6
    c["c"] = 3
    assert "a" in c
    c["d"] = 4
    c["e"] = 5      # access 6: a expires
    assert "a" not in c
    assert c.get("zzz", 7) == 7


def test_lru_ttl_setter_reassigns_expirations():
    c = tcache.LRUCache()
    c["a"] = 1
    c["b"] = 2
    c.time_to_live = 1
    _ = c["b"]
    assert "a" not in c and "b" in c
    c.time_to_live = 5
    c["c"] = 3
    c["d"] = 4
    c["e"] = 5
    assert "b" in c
    c.time_to_live = None
    for i in range(20):
        c[f"k{i}"] = i
    assert "b" in c


@pytest.mark.parametrize("seed", range(4))
def test_lru_random_sequence_matches_jax(seed):
    """The same operations on both packages' caches leave the same keys
    after every one."""
    rng = np.random.default_rng(seed)
    capacity = [None, 3, 5][seed % 3]
    ttl = [None, 4, 7, 2][seed]
    caches = [jcache.LRUCache(capacity, ttl), tcache.LRUCache(capacity, ttl)]
    for step in range(300):
        op = rng.integers(0, 10)
        key = f"k{rng.integers(0, 8)}"
        for c in caches:
            if op < 5:
                c[key] = step
            elif op < 8:
                c.get(key)
            elif op == 8 and key in c:
                c.pop(key)
            elif op == 9:
                c.time_to_live = [None, 3, 6][step % 3]
        assert sorted(caches[0].keys()) == sorted(caches[1].keys())
        assert len(caches[0]) == len(caches[1])


def _ho_state(T=300.0):
    return HarmonicOscillator(device="cpu").thermodynamic_state(T)


def test_compatible_states_share_a_binding():
    cache = tcache.ContextCache()
    integ = BAOABIntegrator(temperature=300.0)
    b1, ts1 = cache.get_context(_ho_state(300.0), integ)
    b2, _ = cache.get_context(_ho_state(400.0), integ)
    assert b1 is b2 and float(ts1.temperature) == 300.0
    assert len(cache) == 1
    # another integrator instance with the same settings hits too
    b3, _ = cache.get_context(_ho_state(), BAOABIntegrator(temperature=350.0))
    assert b3 is b1


def test_other_systems_ensembles_and_settings_bind_their_own():
    cache = tcache.ContextCache()
    integ = BAOABIntegrator(temperature=300.0)
    b_ho, _ = cache.get_context(_ho_state(), integ)
    pair = LennardJonesPair(device="cpu")
    b_lj, _ = cache.get_context(pair.thermodynamic_state(300.0), integ)
    assert b_lj is not b_ho
    b_dt, _ = cache.get_context(_ho_state(),
                                BAOABIntegrator(temperature=300.0,
                                                timestep=0.004))
    assert b_dt is not b_ho
    # an NPT state is an entry of its own; the integrator's own cache (by
    # the system's fingerprint) hands it the same bound integrator, which
    # depends on no ensemble
    npt = _ho_state().replace(pressure=1.0)
    b_npt, _ = cache.get_context(npt, integ)
    assert b_npt is integ.bind(npt.system)
    assert len(cache) == 4
    cache.empty()
    assert len(cache) == 0


def test_content_key_separates_restrained_systems_of_equal_shapes():
    """Two positional restraints of equal shapes about different reference
    positions: the JAX package's structural key shares one binding, the
    port's content key binds each, with its own restraint centres."""
    w = PMEWaterBox(box_edge=2.0, cutoff=0.9, device="cpu")
    x = w.positions
    atoms = list(range(0, w.system.n_particles, 3))
    a = restrain_atoms(w.system, x, atoms, sigma=0.3)
    b = restrain_atoms(w.system, x + 0.05, atoms, sigma=0.3)
    cache = tcache.ContextCache()
    integ = BAOABIntegrator(temperature=300.0)
    ba, _ = cache.get_context(ThermodynamicState(a, 300.0), integ)
    bb, _ = cache.get_context(ThermodynamicState(b, 300.0), integ)
    assert ba is not bb and len(cache) == 2
    for bound, system in ((ba, a), (bb, b)):
        assert torch.equal(bound.system.terms[-1].reference_positions,
                           system.terms[-1].reference_positions)
    # an equal system built anew shares its binding
    again = restrain_atoms(w.system, x.clone(), atoms, sigma=0.3)
    assert cache.get_context(ThermodynamicState(again, 300.0), integ)[0] is ba


def test_default_context_and_any_context_of_the_system():
    ho = HarmonicOscillator(device="cpu")
    cache = tcache.ContextCache()
    bound, thermo = cache.get_context(ho.thermodynamic_state(321.0))
    assert type(bound.integrator) is LangevinIntegrator
    assert bound.integrator.temperature == 321.0
    state = bound.initial_state(ho.sampler_state(),
                                torch.Generator().manual_seed(0),
                                temperature=321.0)
    state = bound.run(state, 5)
    assert torch.isfinite(state.positions).all()
    # with no integrator, a cached context of the system serves
    cache2 = tcache.ContextCache()
    b_baoab, _ = cache2.get_context(ho.thermodynamic_state(300.0),
                                    BAOABIntegrator(temperature=300.0))
    assert cache2.get_context(ho.thermodynamic_state(300.0))[0] is b_baoab
    assert cache2.bound_integrators() == [b_baoab]


def test_cache_keywords_configure_the_default_integrator():
    w = PMEWaterBox(box_edge=2.0, cutoff=0.9, device="cpu")
    ts = w.thermodynamic_state(300.0)
    forced, _ = tcache.ContextCache(sweep="force",
                                    platform="CPU").get_context(ts)
    assert forced.sweep_mode
    auto, _ = tcache.ContextCache().get_context(ts)
    assert not auto.sweep_mode   # "auto" engages on the card only


def test_dummy_cache_keeps_nothing():
    s1 = _ho_state()
    cache = tcache.ContextCache()
    b1, _ = cache.get_context(s1, BAOABIntegrator(temperature=300.0))
    dummy = tcache.DummyContextCache()
    d1, _ = dummy.get_context(s1, BAOABIntegrator(temperature=300.0))
    d2, _ = dummy.get_context(s1)
    assert d1 is not b1 and d2 is not d1
    assert isinstance(tcache.global_context_cache, tcache.ContextCache)
    assert tcache.global_context_cache.capacity is None
