"""Water boxes: the port's models/water.py against the JAX package's.

Every ported variant is built three ways: by the JAX package, by the port
(on the CPU), and by the port's converter from the JAX object's numpy
leaves. The port's own build and the converted one must be the same system
tensor for tensor (equal fingerprints at float32, hence the same arrays as
the JAX package's), with the same positions bit for bit; energy and forces
of the dense path at float64 agree with the JAX package's to rel 1e-10, at
positions jiggled off the built geometry by a numpy seed. Boxes are 1.5 nm
with a 0.7 nm cutoff (125 molecules).
"""
import jax
import numpy as np
import pytest
import torch

from openmmtools_tpu.models import water as jwater
from openmmtools_tpu.system import make_energy_force_fn as jax_ef
from openmmtools_tpu_torch.models import water as twater
from openmmtools_tpu_torch.system import make_energy_force_fn

from test_torch_support import jax_f64, np64, port_system

REL = 1e-10
SMALL = dict(box_edge=1.5, cutoff=0.7)

VARIANTS = [
    ("WaterBox", SMALL),
    ("WaterBox", dict(SMALL, model="spce", nonbonded_method="ewald",
                      switch_width=None, seed=3)),
    ("FlexibleWaterBox", SMALL),
    ("FlexibleReactionFieldWaterBox", SMALL),
    ("FlexiblePMEWaterBox", SMALL),
    ("PMEWaterBox", dict(SMALL, ewald_error_tolerance=1e-5)),
    ("GiantFlexibleWaterBox", SMALL),
    ("FourSiteWaterBox", SMALL),
    ("FiveSiteWaterBox", SMALL),
    ("DischargedWaterBox", SMALL),
    ("FlexibleDischargedWaterBox", SMALL),
    ("GiantFlexibleDischargedWaterBox", SMALL),
    ("DischargedWaterBoxHsites", SMALL),
    ("WaterCluster", dict(n_waters=20)),
]


@pytest.mark.parametrize("name,kwargs", VARIANTS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(VARIANTS)])
def test_water_variant_matches_jax(name, kwargs):
    jw = getattr(jwater, name)(**kwargs)
    tw = getattr(twater, name)(device="cpu", **kwargs)
    assert tw.system.device.type == "cpu"
    converted = port_system(jw.system, dtype=None)
    assert converted.fingerprint == tw.system.fingerprint
    np.testing.assert_array_equal(tw.positions.numpy(), np.asarray(jw.positions))
    assert [type(t).__name__ for t in tw.system.terms] == \
        [type(t).__name__ for t in jw.system.terms]

    # off the built geometry, so that bonded forces are not ~0
    x = np.asarray(jw.positions, np.float64) + np.random.default_rng(
        9).normal(scale=2e-3, size=np.shape(jw.positions))
    box = jw.system.default_box
    if box is not None:
        box = np.asarray(box, np.float64)
    u_j, f_j = jax.jit(jax_ef(jax_f64(jw.system)))(x, box)
    u_t, f_t = make_energy_force_fn(tw.system.to(dtype=torch.float64))(
        torch.as_tensor(x), None if box is None else torch.as_tensor(box))
    assert abs(float(u_t) - float(u_j)) <= REL * abs(float(u_j))
    assert np.abs(np64(f_t) - np.asarray(f_j)).max() <= \
        REL * np.abs(np.asarray(f_j)).max()


def test_slice_water_box_size():
    """PMEWaterBox(box_edge=6.223), the explicit-solvent slice's system:
    20^3 waters, 24,000 atoms, 24,000 constraints, PME alpha 2.628/nm and
    kmax 14 (built on the CPU; its tensors only)."""
    tw = twater.PMEWaterBox(box_edge=6.223, device="cpu")
    assert tw.n_waters == 8000 and tw.system.n_particles == 24000
    assert tw.system.constraints.n_constraints == 24000
    nb, recip = tw.system.terms
    assert (nb.cutoff, nb.switch_width, nb.use_dispersion_correction) == (
        1.0, 0.15, True)
    assert round(recip.alpha, 3) == 2.628 and recip.kmax == 14


def test_unknown_model_and_small_box_raise():
    with pytest.raises(ValueError, match="unsupported water model"):
        twater.WaterBox(model="tip9p", device="cpu")
    with pytest.raises(ValueError, match="2\\*cutoff"):
        twater.WaterBox(box_edge=1.5, cutoff=0.9, device="cpu")
