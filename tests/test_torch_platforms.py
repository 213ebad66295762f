"""The port's parity sweep (``scripts/test_platforms.py``) on the CPU over a
fast subset, one system a force family, with its cpu/f64 energies against
the JAX package's float64 energies; the alchemy benchmark at a small size.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import openmmtools_tpu.models as jmodels
from openmmtools_tpu_torch.scripts import benchmark_alchemy, test_platforms

from test_torch_support import jax_f64

FAST_SUBSET = [
    "HarmonicOscillator",        # external field + global params
    "IdealGas",                  # no forces
    "LennardJonesCluster",       # no_cutoff LJ
    "LennardJonesFluid",         # periodic cutoff + switch
    "SodiumChlorideCrystal",     # Ewald Coulomb + LJ + dispersion
    "DipolarFluid",              # reaction field + exceptions + bonds
    "CustomGBForceSystem",       # GBSA-OBC
    "WaterBox",                  # PME + constraints + exclusions
]


def test_sweep_fast_subset(tmp_path):
    results, failures, skipped = test_platforms.run_sweep(
        names=FAST_SUBSET, failure_dir=str(tmp_path / "failures"),
        verbose=False, device="cpu")
    assert not failures, [(name, key) for name, key, _ in failures]
    assert not skipped
    assert [row["system"] for row in results] == FAST_SUBSET
    for row in results:
        chk = row["checks"]["cpu/f32"]
        assert isinstance(chk, dict) and chk["ok"], row
        # no kernel path engages on the CPU by default (as in the JAX
        # package's CPU sweep)
        assert row["checks"]["kernel"].startswith("n/a"), row
        js = getattr(jmodels, row["system"])()
        jsys = jax_f64(js.system)
        u_jax = float(jsys.energy(jnp.asarray(np.asarray(js.positions,
                                                         np.float64)),
                                  jsys.default_box))
        assert abs(row["U_ref"] - u_jax) <= 1e-10 * max(abs(u_jax), 1e-300)


def test_sweep_skips_only_named_constructor_errors(tmp_path, monkeypatch):
    """A constructor that needs arguments or missing data is skipped and
    named; any other constructor error, and an unknown name, is a
    failure."""
    import openmmtools_tpu_torch.models as tmodels

    class NeedsArgs(tmodels.TestSystem):
        def __init__(self, required, device="cuda"):
            super().__init__(device)

    class NoData(tmodels.TestSystem):
        def __init__(self, device="cuda"):
            raise FileNotFoundError("data not found: x.prmtop")

    class Broken(tmodels.TestSystem):
        def __init__(self, device="cuda"):
            raise RuntimeError("a fault of the port")

    for cls in (NeedsArgs, NoData, Broken):
        monkeypatch.setattr(tmodels, cls.__name__, cls, raising=False)
    results, failures, skipped = test_platforms.run_sweep(
        names=["NeedsArgs", "NoData", "Broken", "NoSuchSystem",
               "GiantFlexibleWaterBox"],
        failure_dir=str(tmp_path / "f"), verbose=False, device="cpu")
    assert [n for n, _ in skipped] == ["NeedsArgs", "NoData",
                                       "GiantFlexibleWaterBox"]
    assert sorted(n for n, _, _ in failures) == ["Broken", "NoSuchSystem"]
    assert not results


def test_main_runs_on_the_cpu(tmp_path, capsys):
    rc = test_platforms.main(["--device", "cpu", "--no-kernels",
                              "--systems", "HarmonicOscillator", "WCAFluid",
                              "--failure-dir", str(tmp_path)])
    assert rc == 0
    assert "all 2 systems consistent" in capsys.readouterr().out


def test_benchmark_alchemy_runs_small(capsys):
    assert benchmark_alchemy.main(["--nparticles", "64", "--n-iterations",
                                   "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "create_alchemical_system" in out
    assert out.count("us/eval") == 2


@pytest.mark.parametrize("name", ["DoubleWellChain_WCAFluid",
                                  "ConstraintCoupledHarmonicOscillator"])
def test_sweep_covers_the_new_systems(tmp_path, name):
    results, failures, _ = test_platforms.run_sweep(
        names=[name], failure_dir=str(tmp_path), verbose=False,
        device="cpu")
    assert not failures and results[0]["checks"]["cpu/f32"]["ok"]
