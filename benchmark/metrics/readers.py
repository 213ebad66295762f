"""The arithmetic the per-layer metrics share. Each reads a
:class:`~benchmark.run.Context` of the traced run and returns a number, or
None where it finds nothing to read (the harness then leaves the metric
out)."""
from __future__ import annotations

from benchmark.metrics import pairs, work

CONSTRAINTS = ("constraints, positions", "constraints, velocities")
PME = ("PME, forward", "PME, backward")
K2_FORCES = "sweep_forces"


def idle_percent(ctx):
    t = ctx.trace
    if t is None or not t.work or t.wall_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.wall_s)


def host_ms_per_unit(ctx, labels):
    t = ctx.trace
    if t is None or not any(r[0] in labels for r in t.ranges):
        return None
    return 1e3 * t.host_s(labels) / t.units


def aten_calls_per_unit(ctx):
    t = ctx.trace
    if t is None or t.aten_calls == 0:
        return None
    return t.aten_calls / t.units


def k2_roofline(ctx):
    """The least time of the evaluations the traced work needs, over K2's
    force kernels' device time in it, in percent."""
    t = ctx.trace
    if t is None:
        return None
    device_s = t.device_s(K2_FORCES)
    if device_s <= 0:
        return None
    spec = ctx.spec
    x = ctx.outputs["x0"]
    trajectories = x if x.ndim == 3 else x[None]
    least = sum(work.least_seconds(
        pairs.brute_force(xt, ctx.outputs["box_edge"], spec.cutoff,
                          spec.exception_pairs, device=ctx.device),
        spec.n_atoms)
        for xt in trajectories)
    needed = least * ctx.evaluations_per_unit * t.units
    return 100.0 * needed / device_s


def span_per_unit(ctx, label):
    if label not in ctx.spans or ctx.span_units <= 0:
        return None
    return ctx.spans[label] / ctx.span_units
