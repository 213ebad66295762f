"""The benchmark is driven by data, and imports no JAX.

A configuration, a traffic mix and a per-layer metric are found by name as
files; adding them edits no file that is there. No module under
``benchmark/`` imports jax, jaxlib, flax or the JAX package (whole
top-level names), and the reference imports nothing of the port."""
import ast
import hashlib
import json
import pathlib
import types

from benchmark import run

HERE = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "openmmtools_tpu"}


def imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not imported(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_port():
    for path in (HERE / "reference").rglob("*.py"):
        assert "openmmtools_tpu_torch" not in imported(path), path
        assert imported(path) <= {"__future__", "math", "dataclasses",
                                  "typing", "numpy", "torch"}, path


def digest(root):
    return {str(p): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(pathlib.Path(root).rglob("*")) if p.is_file()}


TOY_DRIVER = """
import time

FAULTS = {}


class Driver:
    e2e = "toy_rate"
    evaluations_per_unit = 1

    def __init__(self, built, config, traffic, seed, device):
        self.edge, self.pause = built.edge, traffic["pause_s"]

    def setup(self):
        pass

    def unit(self):
        time.sleep(self.pause)
        return 2

    def metric(self, work, units, wall):
        return work / wall

    def outputs(self):
        return {"edge": self.edge}

    def free(self):
        pass


def check(out, spec, device, program=None):
    return {"edge_error": abs(out["edge"] - 2.5)}
"""


def test_a_new_configuration_traffic_and_metric_are_found_by_name(tmp_path):
    """A configuration, a traffic mix of a new kind (its driver and check
    a new file), a cell's limits and a per-layer metric, added as files in
    a copy of the benchmark's layout, are found by name and run end to end;
    no file that is there changes."""
    before = digest(HERE)
    root = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "metrics", "limits"):
        (root / sub).mkdir(parents=True)
    (root / "configs" / "toy-box.json").write_text(json.dumps(
        {"name": "toy-box", "builder": "toy-box.py", "edge": 2.5}))
    (root / "configs" / "toy-box.py").write_text(
        "import types\n\n\ndef build(config, device, workdir):\n"
        "    return types.SimpleNamespace(edge=config['edge'], spec=None)\n")
    (root / "traffic" / "toy.py").write_text(TOY_DRIVER)
    (root / "traffic" / "toy-mix.json").write_text(json.dumps(
        {"driver": "toy", "pause_s": 0.01}))
    (root / "metrics" / "toy.layer_ms.md.py").write_text(
        "def read(ctx):\n    return 2.0 * ctx.span_units\n")
    (root / "limits" / "toy-cell.json").write_text(json.dumps(
        {"edge_error": 0.0}))
    bench = {"configs": [{"name": "toy-box",
                          "file": "benchmark/configs/toy-box.json"}],
             "workloads": [{"name": "toy-cell", "config": "toy-box",
                            "traffic": "toy-mix", "chips": 1}],
             "end_to_end": [{"name": "setup_s", "unit": "s"},
                            {"name": "toy_rate", "unit": "1/s",
                             "workloads": ["toy-cell"]},
                            {"name": "ns_per_day", "unit": "ns/day",
                             "workloads": ["other"]}],
             "per_layer": [{"name": "toy.layer_ms.md",
                            "workloads": ["toy-cell"]}]}
    result, rows = run.run_cell(bench, "toy-cell", 2 ** 31 + 5, 0.05, 0,
                                device="cpu", root=root)
    assert result["correct"] is True, rows
    assert set(result["metrics"]) == {"setup_s", "toy_rate"}
    assert result["metrics"]["toy_rate"]["value"] > 0
    assert result["attempted"] >= 1
    assert result["checks"] == {"edge_error": {"value": 0.0, "limit": 0.0}}
    ctx = types.SimpleNamespace(span_units=3)
    assert run.load_metric("toy.layer_ms.md", root).read(ctx) == 6.0
    assert [m["name"] for m in run.metrics_of(bench, "toy-cell",
                                              "per_layer")] == [
        "toy.layer_ms.md"]
    assert digest(HERE) == before


def test_every_cell_finds_its_files():
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    for cell in bench["workloads"]:
        *_, kind = run.load_cell(bench, cell["name"])
        assert callable(kind.Driver) and callable(kind.check)
        assert set(kind.FAULTS) and run.load_limits(cell["name"])
    for m in bench["per_layer"]:
        assert callable(run.load_metric(m["name"]).read)
