"""The port's ``scripts/demo_free_energy.py`` at a tiny depth on the CPU:
every route runs through the batched program and gives finite numbers of
the expected shapes. The routes' statistical agreement (6 sigma) is held
on the card at depth."""
import json

import numpy as np
import torch

from openmmtools_tpu_torch.scripts import demo_free_energy as demo

TINY = ["--device", "cpu", "--n-iter", "24", "--steps-per-iter", "5",
        "--n-protocols", "4", "--n-steps-neq", "10", "--n-steps-eq", "5",
        "--n-snapshots", "8", "--steps-between", "5", "--n-insertions", "8",
        "--n-eq-widom", "5"]


def test_routes_run_at_tiny_depth():
    fluid, alch_system, compound = demo.build("cpu")
    assert alch_system.n_particles == demo.N_PARTICLES
    w = demo.ncmc_works(fluid, alch_system, True, 21, 4, 5, 10)
    assert w.shape == (4,) and bool(torch.isfinite(w).all())
    assert float(w.std()) > 0.0          # each protocol its own noise
    f, err, seconds = demo.route_c_widom(fluid, compound, n_snapshots=8,
                                         steps_between=5, n_insertions=8,
                                         n_eq=5)
    assert np.isfinite(f) and np.isfinite(err) and seconds > 0.0


def test_main_prints_its_summary(capsys):
    code = demo.main(TINY)
    assert code in (0, 1)
    out = capsys.readouterr().out
    assert "REMD (batched route)" in out
    summary = json.loads(out.strip().splitlines()[-1])
    for key in ("A", "B", "C"):
        assert np.isfinite(summary["dG_kT"][key])
        assert np.isfinite(summary["err_kT"][key])
        assert summary["seconds"][key] > 0.0
    assert summary["device"] == "cpu"
