"""The port's atom sharding (``parallel/atom_shard.py``) against the JAX
package's unsharded ``make_energy_force_fn``, on the CPU at float64 (rel
1e-10), over meshes of CPU entries: the cases of
``tests/test_atom_shard.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmmtools_tpu.models import LennardJonesFluid as JaxLJ
from openmmtools_tpu.models import water as jwater
from openmmtools_tpu.ops.pme import EwaldReciprocalTerm as JaxRecip
from openmmtools_tpu.system import NonbondedTerm as JaxNB
from openmmtools_tpu.system import make_energy_force_fn as jax_ef
from openmmtools_tpu_torch.parallel import replica_mesh
from openmmtools_tpu_torch.parallel.atom_shard import (
    make_sharded_energy_force_fn,
)

# the prmtop systems' skip while their data files are absent
from test_amber import pytestmark as AMBER_DATA
from test_torch_support import jax_f64, np64, port_system

REL = 1e-10


def _mesh(n=8):
    return replica_mesh(devices=[torch.device("cpu")] * n, axis_name="atom")


def _parity(jsys, positions, mesh, params=None, rel=REL):
    x = np.asarray(positions, np.float64)
    box = np.asarray(jsys.default_box, np.float64)
    u0, f0 = jax.jit(jax_ef(jax_f64(jsys)))(
        jnp.asarray(x), jnp.asarray(box),
        {k: jnp.asarray(v, jnp.float64) for k, v in (params or {}).items()})
    fn = make_sharded_energy_force_fn(port_system(jsys), mesh)
    u1, f1 = fn(torch.as_tensor(x), torch.as_tensor(box),
                {k: torch.tensor(v, dtype=torch.float64)
                 for k, v in (params or {}).items()})
    u0, f0 = float(u0), np.asarray(f0)
    assert abs(float(u1) - u0) <= rel * abs(u0), (float(u1), u0)
    assert np.abs(np64(f1) - f0).max() <= rel * np.abs(f0).max()
    return float(u1)


def test_lj_fluid_sharded_parity():
    """Uncharged LJ (switch and dispersion correction), N = 100: not a
    multiple of 8, so the padded tail is masked."""
    f = JaxLJ(nparticles=100)
    _parity(f.system, f.positions, _mesh())


def test_waterbox_pme_sharded_parity():
    """Rigid TIP3P water with PME: row-blocked erfc direct space, the
    partial structure factors summed, exclusions and exception pairs."""
    wb = jwater.WaterBox(box_edge=2.0, cutoff=0.9)
    _parity(wb.system, wb.positions, _mesh())


def test_charge_scale_param_flows_through_shards():
    """A global charge scale reaches the row-blocked direct space and the
    summed structure factors alike, and it matters."""
    wb = jwater.WaterBox(box_edge=2.0, cutoff=0.9)
    terms = tuple(t.replace(charge_scale_param="qscale")
                  if isinstance(t, (JaxNB, JaxRecip)) else t
                  for t in wb.system.terms)
    jsys = wb.system.replace(terms=terms)
    u_full = _parity(jsys, wb.positions, _mesh(), {"qscale": 1.0})
    u_half = _parity(jsys, wb.positions, _mesh(), {"qscale": 0.5})
    assert abs(u_full - u_half) > 1.0


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_mesh_size_independence(n_devices):
    """LJ-50 on 2-, 4- and 8-entry meshes (other paddings and blocks)."""
    f = JaxLJ(nparticles=50)
    _parity(f.system, f.positions, _mesh(n_devices))


def test_virtual_sites_rejected():
    wb = jwater.WaterBox(box_edge=2.0, cutoff=0.9, model="tip4pew")
    with pytest.raises(NotImplementedError, match="virtual"):
        make_sharded_energy_force_fn(port_system(wb.system), _mesh())


@AMBER_DATA
def test_alanine_explicit_sharded_parity():
    from openmmtools_tpu.models.more_systems import AlanineDipeptideExplicit

    t = AlanineDipeptideExplicit()
    _parity(t.system, t.positions, _mesh())


@AMBER_DATA
def test_hostguest_explicit_sharded_parity():
    from openmmtools_tpu.models.more_systems import HostGuestExplicit

    t = HostGuestExplicit()
    _parity(t.system, t.positions, _mesh())
