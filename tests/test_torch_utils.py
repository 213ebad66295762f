"""The port's utils (timing, units, introspection, platforms, equilibration)
against the JAX package's, on the CPU.

* ``Timer``, ``time_it`` and ``with_timer``; the units helpers on a battery
  of expressions, to the JAX package's values and errors; the subclass
  search; the platforms as torch devices; ``utils.__all__`` covering the
  JAX package's list.
* ``run_gentle_equilibration``: the JAX test's protocol on the
  HarmonicOscillator; a restrained minimize-only protocol against the JAX
  package's at float64 (rel 1e-8 in positions, as the minimizer tests hold
  FIRE); and the water protocol of the card's main path at a small size
  (PMEWaterBox(2.0), sweep mode forced through the context cache): a
  restrained minimize, NVT, NPT restrained and NPT free, each stage
  evaluating through the sweep path only, the restraint among the sweep's
  leftover terms, the rigid geometry kept, the box finite.
"""
import abc
import logging
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmmtools_tpu.utils as jutils
import openmmtools_tpu_torch.utils as tutils
from openmmtools_tpu.forces import restrain_atoms as jax_restrain_atoms
from openmmtools_tpu.models import LennardJonesCluster as JaxCluster
from openmmtools_tpu.states import SamplerState as JaxSS
from openmmtools_tpu.states import ThermodynamicState as JaxState
from openmmtools_tpu.utils import equilibration as jeq
from openmmtools_tpu_torch.cache import ContextCache
from openmmtools_tpu_torch.forces import PositionalRestraintTerm
from openmmtools_tpu_torch.integrators.langevin import BoundIntegrator
from openmmtools_tpu_torch.mcmc import LangevinDynamicsMove, MCMCMove
from openmmtools_tpu_torch.models import HarmonicOscillator, PMEWaterBox
from openmmtools_tpu_torch.states import SamplerState, ThermodynamicState
from openmmtools_tpu_torch.utils import equilibration as teq

from test_torch_support import jax_f64, port_system


# -- timing -------------------------------------------------------------------


def test_timer(caplog):
    t = tutils.Timer()
    t.start("x")
    time.sleep(0.01)
    assert t.partial("x") > 0.005
    assert t.stop("x") > 0.005
    assert t.stop("never started") == 0.0
    totals = t.report_timing(clear=False)
    assert set(totals) == {"x"} and totals["x"] > 0.005
    t.reset_timing_statistics("x")
    assert t.report_timing() == {}

    @tutils.time_it
    def f(a):
        return a + 1

    @tutils.with_timer("named")
    def g(a):
        return a * 2

    with caplog.at_level(logging.DEBUG,
                         logger="openmmtools_tpu_torch.utils.timing"):
        assert f(1) == 2 and g(3) == 6
    assert "f took" in caplog.text and "named took" in caplog.text


# -- units --------------------------------------------------------------------

EXPRESSIONS = ["300.0*kelvin", "5", "2.0/picosecond",
               "1.5e-3 * kilojoule/(mole*nanometer**2)", "-.5*bar",
               "  7 * nanometer  "]


@pytest.mark.parametrize("expr", EXPRESSIONS)
def test_quantity_from_string_matches_jax(expr):
    got = tutils.quantity_from_string(expr)
    want = jutils.quantity_from_string(expr)
    assert (got.value, got.unit) == (want.value, want.unit)


@pytest.mark.parametrize("expr", ["kelvin*300", "3*", ""])
def test_quantity_from_string_errors_match_jax(expr):
    for module in (tutils, jutils):
        with pytest.raises(ValueError):
            module.quantity_from_string(expr)


def test_quantity_helpers():
    Q = tutils.Quantity
    assert tutils.is_quantity_close(Q(1.0, "kelvin"), Q(1.0 + 1e-12, "kelvin"))
    assert not tutils.is_quantity_close(Q(1.0, "kelvin"), Q(1.1, "kelvin"))
    assert tutils.is_quantity_close(2.0, 2.0)
    with pytest.raises(TypeError):
        tutils.is_quantity_close(Q(1.0, "kelvin"), Q(1.0, "bar"))
    assert tutils.typename(int) == "int"
    assert tutils.typename(Q(1.0, "kelvin")) == \
        "openmmtools_tpu_torch.storage.iodrivers.Quantity"
    with tutils.temporary_directory() as d:
        assert os.path.isdir(d)
        open(os.path.join(d, "f.txt"), "w").write("x")
    assert not os.path.exists(d)


# -- introspection --------------------------------------------------------------


def test_find_all_subclasses_and_find_subclass():
    class Base:
        pass

    class Mid(Base, abc.ABC):
        @abc.abstractmethod
        def f(self):
            ...

    class Leaf(Mid):
        def f(self):
            return 1

    class Other(Base):
        pass

    for module in (tutils, jutils):
        assert {Base, Mid, Leaf, Other} <= module.find_all_subclasses(Base)
        concrete = module.find_all_subclasses(Base, discard_abstract=True)
        assert Mid not in concrete and {Base, Leaf, Other} <= concrete
        assert Base not in module.find_all_subclasses(Base,
                                                      include_parent=False)
        assert module.find_subclass(Base, "Leaf") is Leaf
        with pytest.raises(ValueError):
            module.find_subclass(Base, "Nope")
        assert module.find_all_subclasses(Mid) == {Leaf}

    class Dup:
        pass

    type("Same", (Dup,), {})
    type("Same", (Dup,), {})
    with pytest.raises(ValueError):
        tutils.find_subclass(Dup, "Same")
    assert tutils.find_subclass(MCMCMove, "LangevinDynamicsMove") \
        is LangevinDynamicsMove


# -- platforms ------------------------------------------------------------------


def test_platforms_are_torch_devices():
    platforms = tutils.get_available_platforms()
    assert platforms[-1] == "CPU"
    assert ("CUDA" in platforms) == torch.cuda.is_available()
    assert tutils.get_fastest_platform() == platforms[0]
    for precision in ("single", "double", "mixed", "Mixed"):
        assert tutils.platform_supports_precision("CPU", precision)
        assert tutils.platform_supports_precision("cuda", precision) == \
            torch.cuda.is_available()
    with pytest.raises(ValueError):
        tutils.platform_supports_precision("CPU", "quad")
    with pytest.raises(ValueError):
        tutils.platform_supports_precision("TPU", "single")
    report = tutils.device_report()
    assert report["platforms"] == platforms
    assert report["torch"] == torch.__version__
    assert report["devices"][0] == "cpu"
    assert len(report["devices"]) == 1 + torch.cuda.device_count()


def test_exports_cover_the_jax_list():
    assert set(jutils.__all__) <= set(tutils.__all__)
    for name in tutils.__all__:
        assert hasattr(tutils, name)


# -- equilibration ------------------------------------------------------------


def test_gentle_equilibration_on_the_oscillator():
    """The JAX package's own test on the port: finite, and the energy
    below the start's."""
    ho = HarmonicOscillator(K=400.0, device="cpu")
    stages = [
        teq.EquilibrationStage(stage_type="minimize", n_steps=50),
        teq.EquilibrationStage(stage_type="nvt", temperature=200.0,
                               n_steps=50, timestep=0.005),
        teq.EquilibrationStage(stage_type="nvt", temperature=300.0,
                               n_steps=50, timestep=0.005),
    ]
    state = ho.thermodynamic_state(300.0)
    ss = SamplerState(positions=torch.tensor([[0.5, 0.5, 0.5]]))
    out = teq.run_gentle_equilibration(state, ss, stages,
                                       context_cache=ContextCache())
    assert not bool(out.has_nan())
    assert float(state.potential_energy(out)) < float(
        state.potential_energy(ss))
    with pytest.raises(ValueError, match="pressure"):
        teq.run_gentle_equilibration(
            state, ss, [teq.EquilibrationStage(stage_type="npt")],
            context_cache=ContextCache())


def test_minimize_protocol_matches_jax():
    """A restrained minimize-only protocol on a displaced LJ cluster: the
    port's positions against the JAX package's at float64."""
    jc = JaxCluster()
    jsys = jax_f64(jc.system)
    x0 = np.asarray(jc.positions, np.float64) + np.random.default_rng(
        2).normal(scale=0.03, size=np.shape(jc.positions))
    stages = [dict(stage_type="minimize", n_steps=60, restraint_sigma=0.05,
                   restrained_atoms=[0, 4, 13])]
    jout = jeq.run_gentle_equilibration(
        JaxState(system=jsys, temperature=np.float64(300.0)),
        JaxSS(positions=jnp.asarray(x0)),
        [jeq.EquilibrationStage(**s) for s in stages])
    psys = port_system(jc.system)
    pout = teq.run_gentle_equilibration(
        ThermodynamicState(system=psys, temperature=300.0),
        SamplerState(positions=torch.as_tensor(x0)),
        [teq.EquilibrationStage(**s) for s in stages],
        context_cache=ContextCache())
    want = np.asarray(jout.positions)
    got = pout.positions.numpy()
    assert not np.allclose(got, x0)
    assert np.abs(got - want).max() <= 1e-8 * np.abs(want).max()
    # the JAX protocol's restrained system, carried across, gives the
    # port's restrained energy at the result
    restrained = jax_restrain_atoms(jsys, jnp.asarray(x0), [0, 4, 13],
                                    sigma=0.05)
    u_j = float(restrained.energy(jnp.asarray(want)))
    u_t = float(port_system(restrained).energy(torch.as_tensor(got)))
    assert abs(u_t - u_j) <= 1e-8 * abs(u_j)


def test_barostat_applies_a_stage():
    assert teq.barostat_applies(teq.EquilibrationStage(n_steps=500)) == 20
    assert teq.barostat_applies(teq.EquilibrationStage(n_steps=10)) == 1


def test_water_protocol_takes_the_sweep_path(monkeypatch):
    """The card's four-stage protocol at a small size, sweep mode forced:
    every evaluation of every stage is the sweep path's (counted by the
    bound system), the restraint rides among the sweep's leftover terms,
    waters stay rigid and the box finite."""
    w = PMEWaterBox(box_edge=2.0, cutoff=0.9, device="cpu")
    system = w.system.to(dtype=torch.float64)
    oxygens = list(range(0, system.n_particles, 3))
    stages = [
        teq.EquilibrationStage(stage_type="minimize", n_steps=4,
                               restraint_sigma=0.3,
                               restrained_atoms=oxygens),
        teq.EquilibrationStage(stage_type="nvt", n_steps=3,
                               restraint_sigma=0.3,
                               restrained_atoms=oxygens),
        teq.EquilibrationStage(stage_type="npt", pressure=1.0, n_steps=3,
                               restraint_sigma=0.3,
                               restrained_atoms=oxygens),
        teq.EquilibrationStage(stage_type="npt", pressure=1.0, n_steps=3),
    ]
    calls = []
    dense = []
    original = BoundIntegrator._sweep_eval

    def counting(self, *args, **kwargs):
        calls.append(self.system.fingerprint)
        return original(self, *args, **kwargs)

    monkeypatch.setattr(BoundIntegrator, "_sweep_eval", counting)
    monkeypatch.setattr(ThermodynamicState, "potential_energy",
                        lambda *a, **k: dense.append(a))
    cache = ContextCache(sweep="force")
    timer = tutils.Timer()
    ss = SamplerState(positions=w.positions.to(torch.float64),
                      box_vectors=system.default_box.clone())
    out = teq.run_gentle_equilibration(
        ThermodynamicState(system=system, temperature=300.0), ss, stages,
        seed=5, context_cache=cache, timer=timer)
    assert not dense
    bounds = cache.bound_integrators()
    # a bound integrator a stage: its own system (three restrained, each
    # about its own start, then the free one)
    assert len(bounds) == 4
    assert len({b.system.fingerprint for b in bounds}) == 4
    for b, restrained in zip(bounds, (True, True, True, False)):
        assert b.sweep_mode
        leftover = [type(t) for t in b._sweep_leftover]
        assert (PositionalRestraintTerm in leftover) == restrained
    counts = [calls.count(b.system.fingerprint) for b in bounds]
    # FIRE: a step each, its final energy, the acceptance check's two;
    # dynamics: the initial state and a step each; the barostat: two an
    # attempt, one attempt an apply
    assert counts == [4 + 1 + 2, 3 + 1, 3 + 1 + 2, 3 + 1 + 2]
    c = system.constraints
    d = out.positions[c.index[:, 0].long()] - out.positions[
        c.index[:, 1].long()]
    assert float((d.norm(dim=-1) - c.distance).abs().max()) < 1e-6
    assert torch.isfinite(out.box_vectors).all()
    totals = timer.report_timing()
    assert set(totals) == {f"stage {i} {p}" for i in range(4)
                           for p in ("setup", "run")}
