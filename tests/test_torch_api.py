"""The last public names of the JAX package in the port, each held against
the JAX package on the CPU: ``BoundIntegrator.pretty_print``,
``ThermodynamicState.is_periodic``, ``stack_sampler_states`` and
``index_sampler_state`` with the reduced potentials of a stacked state,
``ops.geometry.minimum_image_triclinic``,
``TestSystem.reduced_potential_expectation`` and the package's top-level
exports."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmmtools_tpu
import openmmtools_tpu_torch
from openmmtools_tpu import integrators as jint
from openmmtools_tpu import states as jstates
from openmmtools_tpu.models import HarmonicOscillator as JaxHO
from openmmtools_tpu.models import LennardJonesFluid as JaxLJ
from openmmtools_tpu.models import testsystems as jtestsystems
from openmmtools_tpu.ops import geometry as jgeometry
from openmmtools_tpu_torch import integrators as tint
from openmmtools_tpu_torch import states as tstates
from openmmtools_tpu_torch.models import HarmonicOscillator
from openmmtools_tpu_torch.models import LennardJonesFluid
from openmmtools_tpu_torch.models import testsystems as ttestsystems
from openmmtools_tpu_torch.ops import geometry as tgeometry

from test_torch_support import jax_f64, port_system

TEMP = 300.0
REL = 1e-10
K_NAME = "testsystems_HarmonicOscillator_K"

SPLITTINGS = {
    "ghmc": lambda m: m.GHMCIntegrator(temperature=TEMP),
    "baoab": lambda m: m.BAOABIntegrator(temperature=TEMP,
                                         collision_rate=2.0,
                                         timestep=0.002),
    "mts": lambda m: m.LangevinIntegrator(splitting="V0 V1 R O R V1 V0",
                                          temperature=TEMP),
}


@pytest.mark.parametrize("name", sorted(SPLITTINGS))
def test_pretty_print_matches_jax_line_for_line(name):
    """The reference's PrettyPrintableIntegrator listing
    (tests/test_integrators.py:403-413): the header, then one line a
    token, the same text in both packages."""
    jho = JaxHO()
    ho = HarmonicOscillator(device="cpu")
    got = SPLITTINGS[name](tint).bind(ho.system).pretty_print()
    want = SPLITTINGS[name](jint).bind(jho.system).pretty_print()
    assert got.splitlines() == want.splitlines()
    lines = got.splitlines()
    assert lines[0].startswith("# splitting:")
    tokens = tint.parse_splitting(SPLITTINGS[name](tint).splitting)
    assert len(lines) == 1 + len(tokens)
    if name == "ghmc":
        assert "Metropolize" in got and "sqrt(kT/m)" in got
    if name == "mts":
        assert "F[0]" in got and "F[1]" in got


def test_is_periodic_matches_jax():
    for jax_sys, port in ((JaxHO(), HarmonicOscillator(device="cpu")),
                          (JaxLJ(nparticles=32, reduced_density=0.3),
                           LennardJonesFluid(nparticles=32,
                                             reduced_density=0.3,
                                             device="cpu"))):
        want = jax_sys.thermodynamic_state(TEMP).is_periodic
        got = port.thermodynamic_state(TEMP).is_periodic
        assert got is want
    assert HarmonicOscillator(device="cpu").thermodynamic_state(
        TEMP).is_periodic is False
    assert LennardJonesFluid(nparticles=32, device="cpu").thermodynamic_state(
        TEMP).is_periodic is True


def test_stack_and_index_sampler_states_round_trip():
    """tests/test_states.py:300-310: replica i of the stack is replica i."""
    sss = [tstates.SamplerState(positions=torch.full((2, 3), float(i)),
                                velocities=torch.full((2, 3), 10.0 * i),
                                box_vectors=torch.eye(3) * (2.0 + i))
           for i in range(4)]
    batched = tstates.stack_sampler_states(sss)
    assert batched.positions.shape == (4, 2, 3)
    assert batched.velocities.shape == (4, 2, 3)
    assert batched.box_vectors.shape == (4, 3, 3)
    assert batched.n_particles == 2
    jbatched = jstates.stack_sampler_states(
        [jstates.SamplerState(positions=jnp.asarray(ss.positions.numpy()),
                              velocities=jnp.asarray(ss.velocities.numpy()),
                              box_vectors=jnp.asarray(ss.box_vectors.numpy()))
         for ss in sss])
    for i in range(4):
        one = tstates.index_sampler_state(batched, i)
        jone = jstates.index_sampler_state(jbatched, i)
        for field in ("positions", "velocities", "box_vectors"):
            assert torch.equal(getattr(one, field), getattr(sss[i], field))
            np.testing.assert_array_equal(getattr(one, field).numpy(),
                                          np.asarray(getattr(jone, field)))
    # no velocities or boxes anywhere: None in the stack too
    bare = tstates.stack_sampler_states(
        [tstates.SamplerState(positions=torch.zeros((2, 3)))] * 3)
    assert bare.velocities is None and bare.box_vectors is None
    assert tstates.index_sampler_state(bare, 2).velocities is None
    # a mix of None and tensors is refused
    with pytest.raises(tstates.SamplerStateError, match="velocities"):
        tstates.stack_sampler_states(
            [sss[0], tstates.SamplerState(positions=torch.zeros((2, 3)))])
    with pytest.raises(tstates.SamplerStateError):
        tstates.stack_sampler_states([])


def test_reduced_potential_matrix_of_a_stacked_state_matches_jax():
    """tests/test_states.py:103-119 at float64: five configurations at a
    ladder of temperatures and spring constants, stacked or listed, equal
    to the JAX package's matrix at rel 1e-10."""
    jho = JaxHO(K=100.0)
    jsys = jax_f64(jho.system)
    protocol = {"temperature": [290.0, 300.0, 310.0, 320.0],
                K_NAME: [100.0, 150.0, 200.0, 400.0]}
    j_states = jstates.create_thermodynamic_state_protocol(
        jstates.ThermodynamicState(system=jsys, temperature=jnp.asarray(
            TEMP, jnp.float64)), protocol)
    t_states = tstates.create_thermodynamic_state_protocol(
        tstates.ThermodynamicState(system=port_system(jho.system),
                                   temperature=TEMP), protocol)
    rng = np.random.default_rng(7)
    xs = rng.normal(scale=0.02, size=(5, 1, 3))
    stacked = tstates.stack_sampler_states(
        [tstates.SamplerState(positions=torch.as_tensor(x)) for x in xs])
    listed = [tstates.index_sampler_state(stacked, i) for i in range(5)]
    u_stacked = tstates.reduced_potential_matrix(stacked, t_states)
    u_listed = tstates.reduced_potential_matrix(listed, t_states)
    assert u_stacked.shape == (5, 4) and u_stacked.dtype == torch.float64
    assert torch.equal(u_stacked, u_listed)
    assert torch.equal(tstates.reduced_potential_at_states(stacked, t_states),
                       u_stacked)
    u_j = np.asarray(jstates.reduced_potential_matrix(
        jstates.stack_sampler_states(
            [jstates.SamplerState(positions=jnp.asarray(x)) for x in xs]),
        jstates.stack_thermodynamic_states(j_states)))
    np.testing.assert_allclose(u_stacked.numpy(), u_j, rtol=REL, atol=0)


def _reduced_box(rng):
    """A random triclinic box in OpenMM's reduced form."""
    a, b, c = rng.uniform(1.5, 3.0, size=3)
    bx = rng.uniform(-0.5, 0.5) * a
    cx = rng.uniform(-0.5, 0.5) * a
    cy = rng.uniform(-0.5, 0.5) * b
    return np.array([[a, 0.0, 0.0], [bx, b, 0.0], [cx, cy, c]])


@pytest.mark.parametrize("seed", range(4))
def test_minimum_image_triclinic_matches_jax(seed):
    rng = np.random.default_rng(seed)
    box = _reduced_box(rng)
    d = rng.uniform(-3.0, 3.0, size=(257, 3)) * np.diag(box)
    got = tgeometry.minimum_image_triclinic(torch.as_tensor(d),
                                            torch.as_tensor(box)).numpy()
    want = np.asarray(jgeometry.minimum_image_triclinic(
        jnp.asarray(d, jnp.float64), jnp.asarray(box, jnp.float64)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    # the image is a lattice translate of d, reduced along each axis
    n = np.linalg.solve(box.T, (d - got).T).T
    np.testing.assert_allclose(n, np.round(n), atol=1e-9)
    assert np.all(np.abs(got[:, 2]) <= box[2, 2] / 2 + 1e-12)
    # on an orthorhombic box it is the orthorhombic minimum image
    ortho = torch.as_tensor(np.diag(np.diag(box)))
    np.testing.assert_array_equal(
        tgeometry.minimum_image_triclinic(torch.as_tensor(d), ortho).numpy(),
        tgeometry.minimum_image(torch.as_tensor(d), ortho).numpy())


def test_reduced_potential_expectation_raises_on_the_base_class():
    for module, kw in ((ttestsystems, {"device": "cpu"}),
                       (jtestsystems, {})):
        with pytest.raises(NotImplementedError):
            module.TestSystem(**kw).reduced_potential_expectation(None, None)


EXPORTS = ("GlobalParameterFunction", "create_thermodynamic_state_protocol",
           "reduced_potential_at_states", "reduced_potential_matrix",
           "stack_thermodynamic_states", "stack_sampler_states",
           "is_state_compatible", "group_by_compatibility")


@pytest.mark.parametrize("name", EXPORTS)
def test_top_level_exports(name):
    assert hasattr(openmmtools_tpu, name)
    assert getattr(openmmtools_tpu_torch, name) is getattr(tstates, name)
    assert name in openmmtools_tpu_torch.__all__


def test_all_lists_what_the_package_binds():
    for name in openmmtools_tpu_torch.__all__:
        assert hasattr(openmmtools_tpu_torch, name), name
    missing = {n for n in vars(openmmtools_tpu)
               if not n.startswith("_")
               and not hasattr(openmmtools_tpu_torch, n)}
    assert not missing, missing
