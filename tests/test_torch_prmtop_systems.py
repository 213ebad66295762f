"""The 21 prmtop test systems against the JAX package's, each built from
``chip_smoke.py``'s stand-ins at the reference's data paths (the data
directory patched on both sides): the system to the bit, the positions,
ndof and topology; MolecularIdealGas's kept terms, MethanolBox's cutoff,
AlchemicalAlanineDipeptide at three lambda pairs; FileNotFoundError without
data; the real-data cases where the reference's files are present; and
``benchmark_dhfr`` and ``benchmark_remd`` on the CPU at a tiny depth.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import openmmtools_tpu.models as jmodels
import openmmtools_tpu_torch.models as tmodels
from openmmtools_tpu.models import amber as jamber
from openmmtools_tpu_torch.models import amber
from openmmtools_tpu_torch.system import make_energy_fn, value_and_grad

from test_torch_support import jax_f64, np64, port_system

PRMTOP_SYSTEMS = [
    "AlanineDipeptideVacuum", "AlanineDipeptideImplicit",
    "AlchemicalAlanineDipeptide", "HostGuestVacuum", "HostGuestImplicit",
    "HostGuestImplicitHCT", "HostGuestImplicitOBC1", "HostGuestImplicitOBC2",
    "LysozymeImplicit", "BenzeneTolueneImplicit", "MolecularIdealGas",
    "AlanineDipeptideExplicit", "DHFRExplicit", "HostGuestExplicit",
    "TolueneVacuum", "TolueneImplicit", "TolueneImplicitHCT",
    "TolueneImplicitOBC1", "TolueneImplicitOBC2", "MethanolBox",
    "DNADodecamerExplicit",
]
METHANOL_EDGE = 1.6      # nm: the cutoff then comes from the box


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """The stand-in tree: a hexane at every vacuum pair, two hexanes in
    PMEWaterBox(2.0)'s waters at every explicit pair and at dhfr/, and a
    butane in PMEWaterBox(1.6)'s at methanol-box/."""
    root = tmp_path_factory.mktemp("data")
    chip_smoke.write_stand_in_tree(root)
    chip_smoke.write_system(root / "methanol-box", "methanol-box.prmtop",
                            "methanol-box.crd",
                            chip_smoke.solvated_chains(1, 4, METHANOL_EDGE))
    return str(root)


@pytest.fixture
def patched(data_dir, monkeypatch):
    monkeypatch.setattr(jamber, "DEFAULT_DATA_DIR", data_dir)
    monkeypatch.setattr(amber, "DEFAULT_DATA_DIR", data_dir)
    return data_dir


def _both(name, **kw):
    return (getattr(jmodels, name)(**kw),
            getattr(tmodels, name)(device="cpu", **kw))


def test_the_catalog_holds_the_21():
    names = set(tmodels.get_available_testsystems())
    assert set(PRMTOP_SYSTEMS) <= names
    assert len(PRMTOP_SYSTEMS) == 21


@pytest.mark.parametrize("name", PRMTOP_SYSTEMS)
def test_system_matches_jax(patched, name):
    js, ps = _both(name)
    assert port_system(js.system, dtype=None).fingerprint == \
        ps.system.fingerprint
    np.testing.assert_array_equal(ps.positions.numpy(),
                                  np.asarray(js.positions))
    assert ps.positions.dtype == torch.float32
    assert ps.ndof == js.ndof
    if js.topology is None:
        assert ps.topology is None
    else:
        assert ps.topology.atom_names == js.topology.atom_names
        assert ps.topology.residue_names == js.topology.residue_names
        np.testing.assert_array_equal(ps.topology.residue_index,
                                      js.topology.residue_index)


def test_data_dir_argument(data_dir):
    """``data_dir=`` reads the same files as the patched default."""
    js = jmodels.HostGuestExplicit(data_dir=data_dir)
    ps = tmodels.HostGuestExplicit(data_dir=data_dir, cutoff=0.8,
                                   device="cpu")
    assert ps.system.terms[3].cutoff == 0.8
    np.testing.assert_array_equal(ps.positions.numpy(),
                                  np.asarray(js.positions))


def test_molecular_ideal_gas_keeps_bonds_and_angles(patched):
    js, ps = _both("MolecularIdealGas")
    assert [type(t).__name__ for t in ps.system.terms] == [
        "HarmonicBondTerm", "HarmonicAngleTerm"]
    assert ps.system.constraints.n_constraints == 0
    assert ps.ndof == 3 * ps.system.n_particles
    assert ps.system.terms[0].index.shape[0] == 19     # hexane's bonds


def test_methanol_box_cutoff_from_the_inpcrd_box(patched):
    js, ps = _both("MethanolBox")
    cutoff = min(0.9, 0.49 * METHANOL_EDGE)
    assert ps.system.terms[3].cutoff == pytest.approx(cutoff, rel=1e-12)
    assert ps.system.terms[3].cutoff == js.system.terms[3].cutoff
    assert ps.system.terms[3].method == "cutoff_periodic"


@pytest.mark.parametrize("lam", [(1.0, 1.0), (0.5, 0.8), (0.0, 0.3)])
def test_alchemical_alanine_dipeptide_energies(patched, lam):
    """lambda_electrostatics, lambda_sterics: U and F against the JAX
    system at float64."""
    js, ps = _both("AlchemicalAlanineDipeptide")
    params = {"lambda_electrostatics": lam[0], "lambda_sterics": lam[1]}
    x = np.asarray(js.positions, np.float64)
    jsys = jax_f64(js.system)
    u_j, g_j = jax.value_and_grad(
        lambda xx: jsys.energy(xx, None, params))(jnp.asarray(x))
    psys = ps.system.to(dtype=torch.float64)
    u_fn = make_energy_fn(psys)
    tp = {k: torch.tensor(v, dtype=torch.float64) for k, v in params.items()}
    u_p, g_p = value_and_grad(lambda xx: u_fn(xx, None, tp),
                              torch.as_tensor(x))
    assert abs(float(u_p) - float(u_j)) <= 1e-10 * abs(float(u_j))
    g_j = np.asarray(g_j)
    assert np.abs(np64(g_p) - g_j).max() <= 1e-10 * np.abs(g_j).max()


@pytest.mark.parametrize("name", PRMTOP_SYSTEMS)
def test_missing_data_raises(tmp_path, monkeypatch, name):
    monkeypatch.setattr(amber, "DEFAULT_DATA_DIR", str(tmp_path))
    monkeypatch.setattr(jamber, "DEFAULT_DATA_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        getattr(jmodels, name)()
    with pytest.raises(FileNotFoundError):
        getattr(tmodels, name)(device="cpu")


def test_default_data_dir_reads_the_jax_packages_variable(monkeypatch,
                                                          tmp_path):
    import importlib

    monkeypatch.setenv("OPENMMTOOLS_TPU_DATA", str(tmp_path))
    try:
        assert importlib.reload(amber).DEFAULT_DATA_DIR == str(tmp_path)
    finally:
        monkeypatch.delenv("OPENMMTOOLS_TPU_DATA")
        importlib.reload(amber)


REAL_DATA = jamber.DEFAULT_DATA_DIR


@pytest.mark.skipif(
    not os.path.exists(os.path.join(REAL_DATA, "alanine-dipeptide-gbsa")),
    reason="reference data files not available")
@pytest.mark.parametrize("name", ["AlanineDipeptideVacuum",
                                  "AlanineDipeptideImplicit",
                                  "HostGuestVacuum", "TolueneImplicit"])
def test_real_data_matches_jax(name):
    js = getattr(jmodels, name)(data_dir=REAL_DATA)
    ps = getattr(tmodels, name)(data_dir=REAL_DATA, device="cpu")
    assert port_system(js.system, dtype=None).fingerprint == \
        ps.system.fingerprint
    x = np.asarray(js.positions, np.float64)
    jsys = jax_f64(js.system)
    u_j = float(jsys.energy(jnp.asarray(x), jsys.default_box))
    psys = ps.system.to(dtype=torch.float64)
    u_p = float(make_energy_fn(psys)(torch.as_tensor(x), psys.default_box))
    assert abs(u_p - u_j) <= 1e-10 * abs(u_j)


def test_benchmark_dhfr_on_the_cpu(patched, capsys):
    from openmmtools_tpu_torch.scripts import benchmark_dhfr

    rc = benchmark_dhfr.main(["--device", "cpu", "--steps", "3"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "direct-space path" in out and "ms/step" in out
    rc = benchmark_dhfr.main(["--device", "cpu", "--steps", "2",
                              "--reference-defaults", "--no-check"])
    assert rc == 0
    assert "reference testsystem defaults" in capsys.readouterr().out


def test_benchmark_remd_on_the_cpu(patched, capsys):
    from openmmtools_tpu_torch.scripts import benchmark_remd

    rc = benchmark_remd.main(["--device", "cpu", "--replicas", "4",
                              "--steps", "3", "--iters", "2", "--mesh", "2",
                              "--check"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "route batched" in out and "re-verification" in out


def test_parity_sweep_takes_the_prmtop_systems(patched, tmp_path,
                                               monkeypatch):
    """The parity sweep builds the prmtop systems like any other: checked
    from the stand-ins, and skipped by name only when the data are
    absent."""
    from openmmtools_tpu_torch.scripts import test_platforms

    names = ["HostGuestVacuum", "HostGuestImplicitOBC1",
             "AlanineDipeptideExplicit", "MethanolBox", "MolecularIdealGas"]
    results, failures, skipped = test_platforms.run_sweep(
        names=names, failure_dir=str(tmp_path / "f"), verbose=False,
        device="cpu")
    assert not failures and not skipped
    assert [row["system"] for row in results] == names
    monkeypatch.setattr(amber, "DEFAULT_DATA_DIR", str(tmp_path / "none"))
    results, failures, skipped = test_platforms.run_sweep(
        names=names + ["DHFRExplicit"], failure_dir=str(tmp_path / "g"),
        verbose=False, device="cpu")
    assert not failures and not results
    assert [n for n, _ in skipped] == names + ["DHFRExplicit"]
    assert all(r.startswith("data not found") for n, r in skipped[:-1])
