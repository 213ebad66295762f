"""Which force path a bound integrator takes (``integrators/force_paths.py``):
one case on each side of each rule of ``choose_path``, in its order (K1's
fused kernel, K2's sweep, the neighbour list, the dense program). The
rules that read the device take the card from a CPU system that reports
it (``_OnCard``), and those that read the particle count at a size that
would be slow to build here take the count from it too; nothing of either
is evaluated."""
import pytest
import torch

from openmmtools_tpu_torch import integrators as tint
from openmmtools_tpu_torch.integrators.force_paths import choose_path
from openmmtools_tpu_torch.models import (
    AlchemicalWaterBox,
    LennardJonesFluid,
    WaterBox,
)

# a step program with 17 tokens between force sweeps: more than K1's
# chunk table holds
LONG = "V " + "R O " * 8 + "R V"


class _OnCard:
    """A CPU system that reports the card as its device and, where given,
    another particle count; everything else is the system's own."""

    device = torch.device("cuda")

    def __init__(self, system, n=None):
        self._system = system
        self.n_particles = system.n_particles if n is None else n

    def __getattr__(self, name):
        return getattr(self._system, name)


def _systems():
    lj = LennardJonesFluid(nparticles=256, device="cpu").system
    water = WaterBox(box_edge=1.9, cutoff=0.9, device="cpu").system
    alch = AlchemicalWaterBox(box_edge=1.9, cutoff=0.9, device="cpu").system
    soft = alch.replace(terms=tuple(
        t.replace(softcore_beta=0.5) if hasattr(t, "softcore_beta") else t
        for t in alch.terms))
    return {"lj": lj, "water": water, "alch": alch, "soft": soft,
            "lj127": LennardJonesFluid(nparticles=127, device="cpu").system,
            "lj128": LennardJonesFluid(nparticles=128, device="cpu").system,
            "water-narrow": water.replace(
                default_box=torch.diag(torch.full((3,), 1.79,
                                                  dtype=torch.float32)))}


@pytest.fixture(scope="module")
def systems():
    return _systems()


# (case, system, card (None: the CPU; else the count it reports, 0 the
# system's own), integrator class, options, path)
CASES = [
    # K1: a plain R/V/O splitting of an eligible fluid on the card
    ("k1", "lj", 0, "BAOABIntegrator", {}, "K1"),
    ("k1-not-on-the-cpu", "lj", None, "BAOABIntegrator", {},
     "neighbour list"),
    ("k1-not-with-heat", "lj", 0, "BAOABIntegrator",
     {"measure_heat": True}, "dense"),
    ("k1-not-with-shadow-work", "lj", 0, "BAOABIntegrator",
     {"measure_shadow_work": True}, "dense"),
    ("k1-not-metropolized", "lj", 0, "GHMCIntegrator", {}, "dense"),
    ("k1-not-past-its-table", "lj", 0, "LangevinIntegrator",
     {"splitting": LONG}, "dense"),
    ("k1-not-without-a-list", "lj", 0, "BAOABIntegrator",
     {"neighborlist": None}, "dense"),
    ("k1-from-192", "lj", 192, "BAOABIntegrator", {}, "K1"),
    ("k1-not-below-192", "lj", 191, "BAOABIntegrator", {}, "dense"),
    ("k1-up-to-32768", "lj", 32768, "BAOABIntegrator", {}, "K1"),
    ("k1-not-past-32768-so-k2", "lj", 32769, "BAOABIntegrator", {}, "K2"),
    # K2: "auto" on the card from 1,024 atoms, "force"/"interpret" anywhere
    ("k2-auto-from-1024", "lj", 1024, "BAOABIntegrator",
     {"measure_heat": True}, "K2"),
    ("k2-auto-not-below-1024", "lj", 1023, "BAOABIntegrator",
     {"measure_heat": True}, "dense"),
    ("k2-auto-not-on-the-cpu", "water", None, "BAOABIntegrator", {},
     "neighbour list"),
    ("k2-force", "water", None, "BAOABIntegrator", {"sweep": "force"},
     "K2"),
    ("k2-interpret", "water", None, "BAOABIntegrator",
     {"sweep": "interpret"}, "K2"),
    ("k2-off", "water", None, "BAOABIntegrator",
     {"sweep": None, "neighborlist": None}, "dense"),
    ("k2-alchemical", "alch", None, "BAOABIntegrator", {"sweep": "force"},
     "K2-alchemical"),
    ("k2-not-another-softcore", "soft", None, "BAOABIntegrator",
     {"sweep": "force"}, "dense"),
    ("k2-not-past-half-the-box", "water-narrow", None, "BAOABIntegrator",
     {"sweep": "force"}, "neighbour list"),
    ("k2-on-the-mts-group-of-the-term", "water", None, "LangevinIntegrator",
     {"sweep": "force", "splitting": "V0 V1 R O R V1 V0"}, "K2"),
    ("k2-not-without-that-group", "water", None, "LangevinIntegrator",
     {"sweep": "force", "splitting": "V1 R O R V1"}, "dense"),
    ("k2-not-for-a-class-with-its-own-step", "water", None,
     "AndersenVelocityVerletIntegrator", {"sweep": "force"}, "dense"),
    # the neighbour list: from 128 atoms on the CPU, 100,000 on the card
    ("list-from-128-on-the-cpu", "lj128", None, "BAOABIntegrator", {},
     "neighbour list"),
    ("list-not-below-128-on-the-cpu", "lj127", None, "BAOABIntegrator", {},
     "dense"),
    ("list-from-100000-on-the-card", "lj", 100_000, "BAOABIntegrator",
     {"sweep": None}, "neighbour list"),
    ("list-not-below-100000-on-the-card", "lj", 99_999, "BAOABIntegrator",
     {"sweep": None}, "dense"),
]


@pytest.mark.parametrize("case,system,card,cls,options,path",
                         CASES, ids=[c[0] for c in CASES])
def test_the_force_path_follows_the_rules(systems, case, system, card, cls,
                                          options, path):
    integ = getattr(tint, cls)(**options)
    bound = integ.bind(systems[system])
    if card is None:
        chosen = bound.force_path
        assert bound.sweep_mode == path.startswith("K2")
        assert bound.neighbor_mode == (path == "neighbour list")
    else:
        chosen = choose_path(integ, _OnCard(systems[system], card or None),
                             bound.tokens, bound.groups)
    assert chosen.name == path
    assert chosen.per_replica == (path in ("K1", "neighbour list"))
    assert chosen.graphable == path.startswith("K2")
    assert chosen.batches_energies == path.startswith("K2")
    assert chosen.dense_sums == (path in ("dense", "neighbour list"))
