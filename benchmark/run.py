"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix; the harness finds each by its name:

* ``configs/<config>.json`` (the file ``BENCHMARK.json`` gives), which names
  the builder beside it (``configs/<config>.py``, ``build(config, device,
  workdir)``);
* ``traffic/<traffic>.json``, parameters that the driver it names reads:
  ``traffic/<driver>.py`` (:mod:`benchmark.workloads` says what a driver
  module holds), with the check of its cells;
* ``metrics/<metric>.py`` for each per-layer metric, ``read(ctx)``;
* ``limits/<cell>.json``, the limit of each number the check compares.

A run builds its configuration, sets up and warms the cell's own shapes
(``setup_s`` counts from the start of this process), measures whole units
of work for ``--seconds``, checks what the window produced against the
plain reference (the driver's ``check``), and prints one JSON line last on
standard output. With ``--trace 1`` it then also times the sampler's phases
with synchronized spans and profiles a short segment, and the metrics are
the per-layer ones. It needs CUDA cards: without them, or with fewer than
the cell asks for, it prints no result and exits with 2; it exits with 3
if JAX or the JAX package was loaded.
"""
import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Any, Dict  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "openmmtools_tpu")


def _cache_environment():
    """Every build and kernel cache inside the checkout, at fixed paths (the
    program's own kernels already build into ``build/kernels`` there), and
    one host thread for PyTorch and OpenMP: the timed loops are one Python
    thread dispatching to the card, and idle pool threads spinning beside
    it only add noise on a host the card shares."""
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = "1"
    cache = ROOT / "build" / "benchmark-cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path):
    spec = importlib.util.spec_from_file_location(
        "benchmark_" + pathlib.Path(path).stem.replace(".", "_").replace(
            "-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def find(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_config(bench, name, repo=ROOT):
    """The configuration's file and its builder module."""
    entry = find(bench["configs"], name, "configuration")
    path = pathlib.Path(repo) / entry["file"]
    config = load_json(path)
    return config, load_module(path.parent / config["builder"])


def load_traffic(name, root=HERE):
    return load_json(pathlib.Path(root) / "traffic" / f"{name}.json")


def load_driver(traffic, root=HERE):
    """The driver module that a traffic file names."""
    return load_module(pathlib.Path(root) / "traffic"
                       / f"{traffic['driver']}.py")


def load_limits(cell, root=HERE):
    return load_json(pathlib.Path(root) / "limits" / f"{cell}.json")


def load_metric(name, root=HERE):
    return load_module(pathlib.Path(root) / "metrics" / f"{name}.py")


def metrics_of(bench, cell, section):
    """The ``section`` metrics ('end_to_end' or 'per_layer') a cell reports."""
    return [m for m in bench[section]
            if cell in m.get("workloads", [cell])]


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads."""
    trace: Any
    spans: Dict[str, float]
    span_units: int
    outputs: Dict[str, Any]
    spec: Any
    evaluations_per_unit: int
    device: Any


def card_note():
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        done = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return done.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def say(*args):
    print(*args, file=sys.stderr, flush=True)


def load_cell(bench, cell_name, overrides=None, root=HERE):
    """(cell, config, builder, traffic, driver module) of a cell.
    ``overrides`` ({'config': {...}, 'traffic': {...}}) changes sizes for
    tests on the CPU; ``root`` is the benchmark's folder."""
    overrides = overrides or {}
    cell = find(bench["workloads"], cell_name, "workload")
    config, builder = load_config(bench, cell["config"],
                                  repo=pathlib.Path(root).parent)
    config.update(overrides.get("config", {}))
    traffic = load_traffic(cell["traffic"], root)
    traffic.update(overrides.get("traffic", {}))
    return cell, config, builder, traffic, load_driver(traffic, root)


def run_cell(bench, cell_name, seed, seconds, trace, device="cuda",
             t_start=None, overrides=None, root=HERE):
    """Run one cell once; returns (result dict, check rows). ``overrides``
    and ``root`` as in :func:`load_cell`."""
    import torch

    from benchmark import trace as tracing
    from benchmark import check, workloads

    t_start = _T0 if t_start is None else t_start
    cell, config, builder, traffic, kind = load_cell(bench, cell_name,
                                                     overrides, root)
    limits = load_limits(cell_name, root)
    cuda = torch.device(device).type == "cuda"

    with tempfile.TemporaryDirectory() as work:
        built = builder.build(config, device, work)
    spec = built.spec
    drv = kind.Driver(built, config, traffic, seed, device)
    drv.setup()
    setup_s = time.perf_counter() - t_start

    say(f"{cell_name}: set-up {setup_s:.2f} s")
    work, units, wall = workloads.timed_window(drv, seconds, device)
    say(f"{cell_name}: window {units} units, {work} of work in {wall:.3f} s;"
        f" each unit's seconds {[round(t, 3) for t in drv.unit_seconds]}")
    e2e = {"setup_s": setup_s, drv.e2e: drv.metric(work, units, wall)}
    outputs = drv.outputs()

    ctx = Context(trace=None, spans={}, span_units=0, outputs=outputs,
                  spec=spec, evaluations_per_unit=drv.evaluations_per_unit,
                  device=device)
    if trace:
        span_marks = drv.span_marks()
        if span_marks:
            with tracing.marked(span_marks, sync=True) as spans:
                ctx.span_units = sum(
                    drv.trace_unit()
                    for _ in range(int(traffic["span_iterations"])))
            ctx.spans = dict(spans.spans)
        ctx.trace = tracing.profile(drv.trace_unit, drv.marks(), device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    drv.free()
    del drv, built
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    values = kind.check(outputs, spec, device)
    say(f"{cell_name}: the check took {time.perf_counter() - t_check:.2f} s")
    correct, rows = check.verdict(values, limits)

    if trace:
        metrics = {}
        for m in metrics_of(bench, cell_name, "per_layer"):
            value = load_metric(m["name"], root).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(e2e[m["name"]]),
                               "unit": m["unit"]}
                   for m in metrics_of(bench, cell_name, "end_to_end")}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": units, "failed": 0,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = ctx.trace.busy_s()
        dev["window_s"] = ctx.trace.wall_s
        result["breakdown"] = ctx.trace.breakdown()
    # a number that is not finite prints as null (and has failed)
    result["checks"] = {name: {"value": v if v is None or math.isfinite(v)
                               else None, "limit": lim}
                        for name, v, lim in rows}
    return result, rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _cache_environment()
    sys.path.insert(0, str(ROOT))
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = find(bench["workloads"], args.workload, "workload")

    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result, rows = run_cell(bench, args.workload, args.seed, args.seconds,
                            args.trace)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: no result", file=sys.stderr)
        return 3
    result["device"]["power_limit"] = card_note()
    print(f"card: {result['device']['power_limit']}", file=sys.stderr)
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
