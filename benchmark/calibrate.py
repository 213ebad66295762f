"""The readings that a cell's limits are set from, at the cell's own size.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        --seconds <s> [--control 3] [--faults 3]

In one process (the configuration is built once): for each seed, the cell's
set-up and a short window, then the check's numbers for the program (the
lower readings); for the first ``--control`` seeds the same numbers with
the control in the program's place, the reference in float32 with its
k-space products rounded to TF32 (the upper readings); and for the first
``--faults`` seeds each fault of :mod:`benchmark.faults` that the cell's
driver lists, planted in the program. Prints one JSON line a reading and a summary:
the largest program reading and the smallest control and fault readings of
each number. It needs a CUDA card. The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile
import time

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from benchmark import faults, run, workloads  # noqa: E402


def readings(bench, cell_name, seeds, seconds, n_control, n_faults,
             device="cuda", overrides=None):
    """[(role, seed, numbers)] for the program, the control and the faults
    (role 'program', 'control' or 'fault:<name>')."""
    import torch

    from benchmark.reference.energy import Reference

    _, config, builder, traffic, kind = run.load_cell(bench, cell_name,
                                                      overrides)
    with tempfile.TemporaryDirectory() as work:
        built = builder.build(config, device, work)
    spec = built.spec
    control = Reference(spec, device, dtype=torch.float32, tf32=True)

    def one(seed, fault=None):
        drv = kind.Driver(built, config, traffic, seed, device)
        if fault is None:
            drv.setup()
            workloads.timed_window(drv, seconds, device)
            out = drv.outputs()
        else:
            with faults.FAULTS[fault]():
                drv.setup()
                workloads.timed_window(drv, seconds, device)
                out = drv.outputs()
        drv.free()
        return out

    rows = []
    for k, seed in enumerate(seeds):
        t0 = time.perf_counter()
        out = one(seed)
        mine = [("program", seed, kind.check(out, spec, device))]
        if k < n_control:
            mine.append(("control", seed,
                         kind.check(out, spec, device, program=control)))
        for name in kind.FAULTS if k < n_faults else ():
            try:
                values = kind.check(one(seed, name), spec, device)
            except Exception as e:   # a fault that crashes has failed
                values = {"error": repr(e)[:200]}
            mine.append((f"fault:{name}", seed, values))
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
        for role, s, values in mine:
            print(json.dumps({"role": role, "seed": s, "values": values}),
                  flush=True)
        rows += mine
    return rows


def summary(rows):
    """Per number: the largest program reading, the smallest control
    reading and the smallest reading of each fault."""
    out = {}
    for role, _, values in rows:
        for name, v in values.items():
            if not isinstance(v, (int, float)):
                continue
            entry = out.setdefault(name, {})
            if role == "program":
                entry["program_max"] = max(entry.get("program_max", v), v)
            else:
                entry[role + "_min"] = min(entry.get(role + "_min", v), v)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    args = p.parse_args(argv)
    run._cache_environment()
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = readings(bench, args.workload, seeds, args.seconds, args.control,
                    args.faults)
    print(json.dumps({"summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
