"""The Amber loader (``models/amber.py``) against the JAX package's, on
prmtops that ``chip_smoke.py``'s writer makes: the parsers section for
section, the system of every nonbonded method, constraint mode and GB model
(the port's terms equal the JAX system carried over, U and F at rel 1e-10
in float64 and within 2e-4 of the force scale in float32), the selection
DSL, and the water-only prmtop against ``PMEWaterBox``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from openmmtools_tpu.models import amber as jamber
from openmmtools_tpu_torch.integrators import BAOABIntegrator
from openmmtools_tpu_torch.models import amber
from openmmtools_tpu_torch.system import make_energy_fn, value_and_grad

from test_torch_support import jax_f64, np64, port_system

REL64 = 1e-10
F32_SCALE = 2e-4


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A vacuum hexane (with its GB radii) and two hexanes in 188 waters of
    PMEWaterBox(2.0), as prmtop + inpcrd (with and without the box record)
    + PDB."""
    root = tmp_path_factory.mktemp("prmtop")
    vacuum = chip_smoke.vacuum_chain()
    explicit = chip_smoke.solvated_chains(2, 6, 2.0)
    chip_smoke.write_system(root / "vacuum", "v.prmtop", "v.inpcrd", vacuum)
    chip_smoke.write_system(root / "explicit", "e.prmtop", "e.inpcrd",
                            explicit)
    chip_smoke.write_system(root / "explicit", "e.prmtop", "e.pdb", explicit,
                            kind="pdb")
    chip_smoke.write_inpcrd(root / "explicit" / "nobox.inpcrd",
                            explicit.positions)
    return dict(vacuum=root / "vacuum" / "v.prmtop",
                explicit=root / "explicit" / "e.prmtop",
                explicit_crd=root / "explicit" / "e.inpcrd",
                explicit_pdb=root / "explicit" / "e.pdb",
                nobox=root / "explicit" / "nobox.inpcrd",
                tops=(vacuum, explicit))


def test_the_stand_in_carries_what_the_loader_reads(files):
    """Multi-term torsions with the "no 1-4" flag, an improper, CH3/CH2
    clusters and waters, all atom types' LJ."""
    data = amber.parse_prmtop(str(files["explicit"]))
    dih = data["DIHEDRALS_WITHOUT_HYDROGEN"].reshape(-1, 5)
    assert (dih[:, 2] < 0).sum() >= 2 and (dih[:, 3] >= 0).all()
    dih_h = data["DIHEDRALS_INC_HYDROGEN"].reshape(-1, 5)
    assert (dih_h[:, 3] < 0).sum() == 2          # one improper a chain
    assert int(data["POINTERS"][1]) == 4
    assert set(data["RESIDUE_LABEL"]) == {"LIG", "WAT"}
    assert len(data["BOX_DIMENSIONS"]) == 4
    assert 60 <= (data["RESIDUE_LABEL"] == "WAT").sum() <= 200


@pytest.mark.parametrize("which", ["vacuum", "explicit"])
def test_parse_prmtop_matches_jax(files, which):
    mine = amber.parse_prmtop(str(files[which]))
    theirs = jamber.parse_prmtop(str(files[which]))
    assert sorted(mine) == sorted(theirs)
    for flag, values in mine.items():
        assert values.dtype.kind == np.asarray(theirs[flag]).dtype.kind, flag
        np.testing.assert_array_equal(values, theirs[flag], err_msg=flag)


def test_parse_inpcrd_and_pdb_match_jax(files):
    top = files["tops"][1]
    x = np.asarray(top.positions)
    got, box = amber.parse_inpcrd(str(files["explicit_crd"]),
                                  return_box=True)
    want, jbox = jamber.parse_inpcrd(str(files["explicit_crd"]),
                                     return_box=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(box, jbox)
    assert box == pytest.approx([2.0] * 3)
    assert np.abs(got - x).max() < 1e-8
    np.testing.assert_array_equal(amber.parse_inpcrd(str(files["explicit_crd"])),
                                  want)
    got, box = amber.parse_inpcrd(str(files["nobox"]), return_box=True)
    want, jbox = jamber.parse_inpcrd(str(files["nobox"]), return_box=True)
    np.testing.assert_array_equal(got, want)
    assert box is None and jbox is None
    pdb = amber.parse_pdb_positions(str(files["explicit_pdb"]))
    np.testing.assert_array_equal(
        pdb, jamber.parse_pdb_positions(str(files["explicit_pdb"])))
    assert np.abs(pdb - x).max() <= 0.5e-4 + 1e-12


def _both(path, **kw):
    js = jamber.create_system_from_prmtop(str(path), **kw)
    ps = amber.create_system_from_prmtop(str(path), device="cpu", **kw)
    return js, ps


def _jax_uf(system, x):
    u, g = jax.value_and_grad(
        lambda xx: system.energy(xx, system.default_box))(jnp.asarray(x))
    return float(u), -np.asarray(g, np.float64)


def _port_uf(system, x):
    u_fn = make_energy_fn(system)
    u, g = value_and_grad(lambda xx: u_fn(xx, system.default_box),
                          torch.as_tensor(x))
    return float(u), -np64(g)


METHODS = ["no_cutoff", "cutoff_periodic", "pme", "ewald"]
CONSTRAINTS = [None, "h-bonds", "all-bonds"]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("constraints", CONSTRAINTS)
def test_system_terms_equal_jax(files, method, constraints):
    """The port's system is the JAX system carried over, term for term and
    to the bit (the float32 parameters), for each method and constraint
    mode."""
    js, ps = _both(files["explicit"], nonbonded_method=method,
                   constraints=constraints)
    assert port_system(js, dtype=None).fingerprint == ps.fingerprint
    assert [type(t).__name__ for t in ps.terms] == [
        type(t).__name__ for t in js.terms]
    n_h = 3 * 188 + 2 * 14
    assert ps.constraints.n_constraints == {
        None: 0, "h-bonds": n_h, "all-bonds": n_h + 2 * 5}[constraints]
    if method in ("pme", "ewald"):
        nb, rec = ps.terms[3], ps.terms[4]
        assert torch.equal(rec.exclusion_index, nb.exception_index)


ENERGY_CASES = [
    ("explicit", dict(nonbonded_method=m)) for m in METHODS
] + [
    ("explicit", dict(nonbonded_method="pme", constraints=None)),
    ("explicit", dict(nonbonded_method="pme", constraints="all-bonds",
                      cutoff=0.8, switch_width=0.1,
                      ewald_error_tolerance=1e-5)),
] + [
    ("vacuum", dict(implicit_solvent=True, gb_model=g))
    for g in ("HCT", "OBC1", "OBC2")
]


@pytest.mark.parametrize("which,kw", ENERGY_CASES,
                         ids=[f"{w}-{'-'.join(map(str, k.values()))}"
                              for w, k in ENERGY_CASES])
def test_energy_and_forces_match_jax(files, which, kw):
    js, ps = _both(files[which], **kw)
    x = np.asarray(files["tops"][0 if which == "vacuum" else 1].positions)
    u_j, f_j = _jax_uf(jax_f64(js), x)
    u_p, f_p = _port_uf(ps.to(dtype=torch.float64), x)
    assert abs(u_p - u_j) <= REL64 * abs(u_j)
    assert np.abs(f_p - f_j).max() <= REL64 * np.abs(f_j).max()
    # float32, as each package stores the system
    x32 = x.astype(np.float32)
    u_j32, f_j32 = _jax_uf(js, x32)
    u_p32, f_p32 = _port_uf(ps, x32)
    scale = np.abs(f_j).max()
    assert np.abs(f_p32 - f_j).max() <= F32_SCALE * scale
    assert np.abs(f_j32 - f_j).max() <= F32_SCALE * scale
    # a float32 sum of pair energies that cancel to a few hundred kJ/mol
    # (the unscreened Coulomb sum of no_cutoff most of all)
    assert abs(u_p32 - u_j) <= 1e-4 * abs(u_j)
    assert abs(u_j32 - u_j) <= 1e-4 * abs(u_j)


def test_gb_models_and_errors(files):
    _, obc2 = _both(files["vacuum"], implicit_solvent=True)
    gb = obc2.terms[-1]
    assert (gb.obc_alpha, gb.obc_beta, gb.obc_gamma) == (1.0, 0.8, 4.85)
    _, hct = _both(files["vacuum"], implicit_solvent=True, gb_model="hct")
    assert hct.terms[-1].hct
    with pytest.raises(ValueError, match="unsupported gb_model"):
        amber.create_system_from_prmtop(str(files["vacuum"]),
                                        implicit_solvent=True,
                                        gb_model="GBn", device="cpu")
    with pytest.raises(ValueError, match="BOX_DIMENSIONS"):
        amber.create_system_from_prmtop(str(files["vacuum"]),
                                        nonbonded_method="pme", device="cpu")


def _alanine_like_topology():
    """ACE-ALA-NME's 22 atom names and three waters: a prmtop whose
    residues the DSL's protein, backbone and water keywords see."""
    top = chip_smoke.Topology()
    residues = [("ACE", ["HH31", "CH3", "HH32", "HH33", "C", "O"]),
                ("ALA", ["N", "H", "CA", "HA", "CB", "HB1", "HB2", "HB3",
                         "C", "O"]),
                ("NME", ["N", "H", "CH3", "HH31", "HH32", "HH33"])]
    c3, hc = chip_smoke.GAFF_TYPES["c3"], chip_smoke.GAFF_TYPES["hc"]
    for label, names in residues:
        top.add_residue(label)
        for name in names:
            top.add_atom(name, hc if name.startswith("H") else c3, 0.0,
                         [0.0, 0.0, 0.0])
    chip_smoke.add_waters(top, np.zeros((3, 3, 3)))
    return top


DSL = ["protein and name CA", "all", "none", "hydrogen", "heavy",
       "not hydrogen", "backbone", "sidechain", "protein", "water",
       "resid 0 to 1", "name CA CB", "(name CA) or (name CB)",
       "water or resname ALA", "not hydrogen and resid 0 to 9",
       "index 3 to 7", "resname NME and not (name N or name H)",
       "resSeq 2", "index 0 21 22", "not not water"]
DSL_ERRORS = ["name CA extra_garbage and", "bogus_keyword", "(name CA",
              "name", "resid 1 to"]


@pytest.fixture(scope="module")
def topologies(tmp_path_factory):
    path = tmp_path_factory.mktemp("dsl") / "ala.prmtop"
    chip_smoke.write_prmtop(path, _alanine_like_topology())
    return (amber.AmberTopology(amber.parse_prmtop(str(path))),
            jamber.AmberTopology(jamber.parse_prmtop(str(path))))


@pytest.mark.parametrize("expr", DSL)
def test_selection_matches_jax(topologies, expr):
    mine, theirs = topologies
    got = mine.select(expr)
    np.testing.assert_array_equal(got, theirs.select(expr))
    assert got.dtype == np.asarray(theirs.select(expr)).dtype


def test_selection_keywords_and_errors(topologies):
    mine, theirs = topologies
    assert mine.atom_names == theirs.atom_names
    assert mine.residue_names == theirs.residue_names
    np.testing.assert_array_equal(mine.residue_index, theirs.residue_index)
    for kw in (dict(name="CA"), dict(resname="WAT"),
               dict(resname="ALA", name="C"), {}):
        np.testing.assert_array_equal(mine.select(**kw), theirs.select(**kw))
    assert len(mine.select("protein")) == 22
    assert list(mine.select("protein and name CA")) == [8]
    for expr in DSL_ERRORS:
        with pytest.raises(ValueError) as want:
            theirs.select(expr)
        with pytest.raises(ValueError) as got:
            mine.select(expr)
        assert str(got.value) == str(want.value)


def test_water_prmtop_matches_pme_water_box(tmp_path):
    """Phase 18b at box_edge 2.5: the water-only prmtop through the loader
    against PMEWaterBox's own system at its positions, both in sweep mode
    (the kernels' plain versions here): U at rel 1e-6 in float64 (the
    prmtop carries 9 significant digits) and F within 2e-4 of the force
    scale in float32. (At this unrelaxed start |U| is only 1,065 kJ/mol,
    and one float32 rounding of the remainder's 1e5 kJ/mol intermediate
    sums is 0.016 of it, so U is held in float64; the card holds the
    float32 U at 24,000 atoms.)"""
    top, w = chip_smoke.water_box_topology(2.5)
    path = tmp_path / "water.prmtop"
    chip_smoke.write_prmtop(path, top)
    term = w.system.terms[0]
    loaded = amber.create_system_from_prmtop(
        str(path), nonbonded_method="pme", cutoff=term.cutoff,
        switch_width=term.switch_width, ewald_error_tolerance=5e-4,
        device="cpu")
    assert loaded.n_particles == w.system.n_particles == 1536
    assert loaded.constraints.n_constraints == 3 * 512
    np.testing.assert_allclose(loaded.terms[3].charge.numpy(),
                               term.charge.numpy(), rtol=1e-7)
    np.testing.assert_allclose(loaded.terms[3].sigma.numpy(),
                               term.sigma.numpy(), rtol=1e-6)
    np.testing.assert_allclose(loaded.terms[3].epsilon.numpy(),
                               term.epsilon.numpy(), rtol=1e-6)
    assert loaded.terms[4].kmax == w.system.terms[1].kmax
    out = {}
    for dtype in (torch.float32, torch.float64):
        x = w.positions.to(dtype)
        for name, system in (("loaded", loaded), ("box", w.system)):
            system = system.to(dtype=dtype)
            bound = BAOABIntegrator(temperature=300.0,
                                    sweep="force").bind(system)
            assert bound.sweep_mode
            assert bound.constraint_solver.settle is not None
            assert bound.constraint_solver.rest is None
            assert bound.force_path.recip is not None
            u, f = bound.energy_forces_at(x, system.default_box, {})
            out[name, dtype] = (float(u), np64(f))
    (u_l, _), (u_w, _) = out["loaded", torch.float64], out[
        "box", torch.float64]
    assert abs(u_l - u_w) <= 1e-6 * abs(u_w)
    f_l, f_w = out["loaded", torch.float32][1], out["box", torch.float32][1]
    assert np.abs(f_l - f_w).max() <= F32_SCALE * np.abs(f_w).max()
