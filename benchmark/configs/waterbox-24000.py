"""Builds ``waterbox-24000``: the program's ``WaterBox`` at the
configuration's sizes; the reference's parameters from the water model's
published numbers in the configuration file, with no alchemical region."""
from __future__ import annotations

import types

from benchmark.reference import forcefield


def build(config, device, workdir):
    from openmmtools_tpu_torch.models import WaterBox

    ts = WaterBox(
        box_edge=config["box_edge_nm"], cutoff=config["cutoff_nm"],
        model=config["water_model"]["name"],
        switch_width=config["switch_width_nm"],
        ewald_error_tolerance=config["ewald_error_tolerance"], device=device)
    if ts.system.n_particles != config["n_atoms"]:
        raise ValueError(f"the box has {ts.system.n_particles} atoms, the "
                         f"configuration states {config['n_atoms']}")
    spec = forcefield.water_spec(
        config["n_waters"], config["box_edge_nm"], config["water_model"],
        config["cutoff_nm"], config["ewald_error_tolerance"],
        config["switch_width_nm"], alchemical_waters=())
    return types.SimpleNamespace(testsystem=ts, spec=spec)
