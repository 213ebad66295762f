"""On a card: each cell runs as its command line runs it, and comes out
correct. ``python -m pytest benchmark/tests -m cuda`` on the card; skips
elsewhere."""
import json
import subprocess
import sys

import pytest
import torch

from benchmark import run


CELLS = [c["name"] for c in run.load_json(run.ROOT / "BENCHMARK.json")[
    "workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_of_each_cell_is_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    done = subprocess.run(
        [sys.executable, str(run.HERE / "run.py"), "--workload", cell,
         "--seed", str(2 ** 31 + 99), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=run.ROOT, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"


def test_without_a_card_the_run_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    done = subprocess.run(
        [sys.executable, str(run.HERE / "run.py"), "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=run.ROOT, timeout=300)
    assert done.returncode != 0
    assert done.stdout.strip() == ""
