"""A run with the timed path broken underneath comes out not correct (on
the CPU, at a small size: the whole run but the look for a card,
``run.run_cell``), and so does the control in the program's place."""
import pathlib
import time

import numpy as np
import pytest
import torch

from benchmark import check, faults, run
from benchmark.reference import forcefield
from benchmark.reference.energy import K_BOLTZMANN, Reference
from benchmark.tests.test_bench_reference import water

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
# each cell's size for a run on the CPU: ``small/<cell>.json``, the
# overrides of its configuration and traffic
SMALL = {p.stem: run.load_json(p)
         for p in sorted((pathlib.Path(__file__).parent / "small")
                         .glob("*.json"))}
# each cell's faults, as its driver lists them, with the number that
# catches each
CASES = [(cell, fault, number) for cell in SMALL
         for fault, number in run.load_cell(BENCH, cell)[4].FAULTS.items()]


def small_run(cell):
    return run.run_cell(BENCH, cell, 2 ** 31 + 7, 0.01, 0, device="cpu",
                        t_start=time.perf_counter(), overrides=SMALL[cell])


def test_every_cell_has_a_small_size():
    assert {c["name"] for c in BENCH["workloads"]} == set(SMALL)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_small_run_of_each_cell_is_correct(cell):
    result, rows = small_run(cell)
    assert result["correct"] is True, result["checks"]


@pytest.mark.parametrize("cell,fault,number", CASES)
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault, number):
    with faults.FAULTS[fault]():
        result, rows = small_run(cell)
    assert result["correct"] is False
    number = result["checks"][number]
    assert number["value"] > number["limit"], (fault, result["checks"])


def spec_at(name, x, edge):
    """The Spec of configuration ``name`` at the waters ``x`` in a box of
    ``edge``."""
    cfg, _ = run.load_config(BENCH, name)
    spec = forcefield.water_spec(
        len(x) // 3, edge, cfg["water_model"], cfg["cutoff_nm"],
        cfg["ewald_error_tolerance"], cfg["switch_width_nm"],
        cfg.get("alchemical_waters", ()))
    return cfg, spec


def test_the_control_in_the_programs_place_is_not_correct():
    """The reference in float32 with its k-space products in TF32 (the
    nearest precision below the configurations' float32 with TF32 off), in
    the program's place at the benchmark's own input positions of a 3.5 nm
    cut of the configuration: its forces at the coupled state and its
    reduced potentials over the ladder break the cell's limits."""
    x, edge = water(n_side=11, edge=3.5)
    alch, spec = spec_at("alch-water-24000", x, edge)
    reference = Reference(spec, "cpu")
    control = Reference(spec, "cpu", dtype=torch.float32, tf32=True)
    limits = run.load_limits("re-alch-ladder")
    f_ref = reference.energy_forces(x, edge)[1]
    f_ctl = control.energy_forces(x, edge)[1]
    assert check.force_error(f_ctl, f_ref) > limits["force_rel"]

    lad = alch["lambda_ladder"]
    ladder = list(zip(lad["lambda_electrostatics"], lad["lambda_sterics"]))
    beta = 1.0 / (K_BOLTZMANN * alch["temperature_K"])
    u_ref = beta * np.asarray(reference.energies_over(x, edge, ladder))
    u_ctl = beta * np.asarray(control.energies_over(x, edge, ladder))
    assert check.matrix_row_error(u_ctl, u_ref) > limits["matrix_kT"]
