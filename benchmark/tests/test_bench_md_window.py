"""``water-md``'s numbers of the timed window itself: ``window_chain`` holds
the last iteration's start to the iteration before's end, and
``window_still`` the waters' displacement over the iteration to a free
particle's under the same thermostat. A window that does not advance, or a
sampler that does not carry its state, comes out not correct (on the CPU,
at the cell's small size); the check's steps run eagerly without the
move's step graph."""
import numpy as np
import pytest

from benchmark import faults, run
from benchmark.reference import forcefield
from benchmark.reference.energy import K_BOLTZMANN
from benchmark.tests.test_bench_faults import small_run
from benchmark.tests.test_bench_reference import TIP3P, water

DRIVER = run.load_cell(run.load_json(run.ROOT / "BENCHMARK.json"),
                       "water-md")[4]
LIMITS = run.load_limits("water-md")


def _outputs(x_start, x_end, edge, **kw):
    n = len(x_start)
    out = dict(xw=x_start, x0=x_end, box_edge=edge, xp=x_start.copy(),
               vw=np.zeros((n, 3)), vp=np.zeros((n, 3)), n_steps=250,
               dt=0.002, gamma=1.0, temperature=300.0)
    out.update(kw)
    return out


@pytest.fixture(scope="module")
def box():
    x, edge = water(n_side=4, edge=1.25)
    spec = forcefield.water_spec(len(x) // 3, edge, TIP3P, 0.6, 5e-4, 0.1)
    return x, edge, spec


def test_window_still_against_a_free_particle(box):
    """Every water moved by the same 0.1 nm, across the box's face for
    some: the free particle's root mean square over it."""
    x, edge, spec = box
    shift = np.array([0.06, 0.0, 0.08])
    end = np.mod(x + shift, edge)
    values = DRIVER.window_numbers(_outputs(x, end, edge), spec)
    mass = sum(TIP3P[k] for k in ("mass_O", "mass_H", "mass_H"))
    gt = 1.0 * 250 * 0.002
    free = (6.0 * K_BOLTZMANN * 300.0 / mass * (gt - 1.0 + np.exp(-gt)))
    assert values["window_still"] == pytest.approx(np.sqrt(free) / 0.1,
                                                   rel=1e-9)
    assert values["window_chain"] == 0.0


def test_a_window_that_does_not_move_reads_infinity(box):
    x, edge, spec = box
    values = DRIVER.window_numbers(_outputs(x, x.copy(), edge), spec)
    assert values["window_still"] == np.inf


@pytest.mark.parametrize("field, change", [("xp", 0.01), ("vp", -0.5)])
def test_window_chain_reads_the_largest_break(box, field, change):
    x, edge, spec = box
    out = _outputs(x, x + 0.05, edge)
    out[field] = out[field].copy()
    out[field][7, 1] += change
    assert DRIVER.window_numbers(out, spec)["window_chain"] == \
        pytest.approx(abs(change), rel=1e-12)


def _run_stuck():
    from openmmtools_tpu_torch.integrators.langevin import BoundIntegrator

    return faults.patched(BoundIntegrator, "run",
                          lambda run_: lambda self, state, n: state)


def _not_carried():
    from openmmtools_tpu_torch.mcmc import MCMCSampler

    def make(run_):
        def run1(self, n_iterations=1):
            for _ in range(n_iterations):
                self.move.apply(self.thermodynamic_state, self.sampler_state)
        return run1
    return faults.patched(MCMCSampler, "run", make)


@pytest.mark.parametrize("fault, number", [(_run_stuck, "window_still"),
                                           (_not_carried, "window_chain")])
def test_a_window_fault_is_not_correct(fault, number):
    with fault():
        result, _ = small_run("water-md")
    assert result["correct"] is False
    value = result["checks"][number]["value"]
    # a number that is not finite prints as None
    assert value is None or value > LIMITS[number], result["checks"]


def test_the_checks_steps_run_eagerly(monkeypatch):
    """The window's runs may take the step graph, the check's one-step
    runs may not."""
    seen = []
    from openmmtools_tpu_torch.integrators.langevin import BoundIntegrator

    original = BoundIntegrator.run

    def run1(self, state, n):
        seen.append((n, self._graph_program))
        return original(self, state, n)
    monkeypatch.setattr(BoundIntegrator, "run", run1)
    result, _ = small_run("water-md")
    assert result["correct"] is True, result["checks"]
    assert [g for n, g in seen if n == 1] == [False] * DRIVER.CHECK_STEPS
    assert all(g for n, g in seen if n > 1)
