"""K2's bound pass (``measure_bound``) on rings where the bound cuts the
ring, fresh and stale, against the JAX package; and the bound kernel's cull
and scan, mirrored here in torch, against the plain bound.

* ``measure_bound_reference`` at float32 against the JAX kernel
  ``SweepNonbonded(interpret=True)`` (the third output of ``forces`` with the
  rebuild flag set) on a 3.1 nm water box at rc 0.9 nm, where the bound lies
  below ``n_blocks``: on a fresh sort, and on a stale ring (positions moved
  after the sort and gathered through the old order, some atoms carried
  across the x face), as the path rebuilds between two re-sorts. Equal ints.
* ``far_tiles`` (the kernel's cull rule: a partner tile skipped for a group
  of 32 slots when their periodic x-arcs lie farther apart than w with a
  margin) never skips a tile that holds a pair within w = rc + skin of the
  group, on fresh, stale, small, elongated, ragged and outlier rings.
* The kernel's scan (each group's partner tiles far to near, the cull, a
  stop once no nearer tile can beat the best block found) gives the plain
  bound exactly on the same rings.
* ``chip_smoke.bound_floor_tests``, the tile tests that the card's bound in
  the ``kernels`` line counts, is a floor: no more than the scan tests, in
  either order of its groups' bests.

Every dtype is given on both sides: the suite's conftest turns on x64.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from openmmtools_tpu.models import water as jwater
from openmmtools_tpu.ops import sweep_nb as jsw
from openmmtools_tpu_torch.models import PMEWaterBox
from openmmtools_tpu_torch.ops import sweep_nb as tsw

CUTOFF = 0.9
SKIN = 0.1
BS = 8


def _stale(x, L, rng, spread, crossing):
    """Positions moved by normal steps of ``spread`` nm a coordinate, and the
    ``crossing`` atoms nearest the upper x face carried 0.3 nm across it."""
    x = x + rng.normal(scale=spread, size=x.shape)
    xw = x - L * np.floor(x / L)
    x[np.argsort(-xw[:, 0])[:crossing], 0] += 0.3
    return x


def _jax_ring(stale):
    """A 3.1 nm water box (3,000 atoms) sorted by x, float32 (n_pad, 3) with
    the pad rows at 1e6; stale: moved after the sort."""
    jw = jwater.WaterBox(box_edge=3.1, cutoff=CUTOFF)
    n = jw.system.n_particles
    n_pad = -(-n // 128) * 128
    x = np.asarray(jw.positions, np.float64)
    box = np.asarray(jw.system.default_box, np.float32)
    L = np.diagonal(box).astype(np.float64)
    perm, _ = jsw.sort_for_sweep(jnp.asarray(x, jnp.float32),
                                 jnp.asarray(box), n_pad)
    if stale:
        x = _stale(x, L, np.random.default_rng(3), 0.06, 20)
    y = (x - L * np.floor(x / L))[np.asarray(perm)]
    y = np.concatenate([y, np.full((n_pad - n, 3), 1e6)]).astype(np.float32)
    return n, n_pad, y, box


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
def test_plain_bound_matches_jax_below_the_whole_ring(stale):
    n, n_pad, y, box = _jax_ring(stale)
    mask_rows = min(2048, max(32, (n_pad // 2 // 32) * 32)) // 32
    jk = jsw.SweepNonbonded(n, "pme", CUTOFF, ewald_alpha=3.0,
                            mask_shells=32 * mask_rows, interpret=True)
    par = np.zeros((n_pad, 3), np.float32)
    excl = np.zeros((mask_rows, n_pad), np.int32)
    _, _, nb_j = jk.forces(jnp.asarray(y, jnp.float32),
                           jnp.asarray(par, jnp.float32),
                           jnp.asarray(box, jnp.float32), jnp.asarray(excl),
                           jnp.asarray(True), jnp.int32(0))
    xT = torch.as_tensor(y.T.copy(), dtype=torch.float32)
    L = torch.as_tensor(np.diagonal(box).copy(), dtype=torch.float32)
    nb_t = tsw.measure_bound_reference(
        xT, L, torch.tensor(True), torch.tensor(0, dtype=torch.int32), n=n,
        cutoff=CUTOFF, skin=SKIN, shell_block=BS)
    assert nb_t.dtype == torch.int32
    n_blocks = -(-(n_pad // 2) // BS)
    assert 0 < int(nb_t) == int(nb_j) < n_blocks


def _ring(kind):
    """(xT (3, n_pad) float32, L (3,) float32, n) of one test ring."""
    rng = np.random.default_rng(7)
    edge = 1.9 if kind.startswith("small") else 3.1
    w = PMEWaterBox(box_edge=edge, cutoff=CUTOFF, device="cpu")
    x = w.positions.to(torch.float64).numpy()
    box = w.system.default_box.to(torch.float64).numpy()
    if kind == "elongated":
        # the box twice along z: (3.1, 3.1, 6.2) nm, 6,000 atoms
        x = np.concatenate([x, x + np.array([0.0, 0.0, box[2, 2]])])
        box = box.copy()
        box[2, 2] *= 2
    if kind == "ragged":
        x = x[:2900]          # 2,900 atoms: a last tile of 20 real slots
    L = np.diagonal(box).copy()
    n = x.shape[0]
    n_pad = -(-n // 128) * 128
    perm, _ = tsw.sort_for_sweep(torch.as_tensor(x), torch.as_tensor(box),
                                 n_pad)
    if kind in ("stale", "small-stale", "elongated", "ragged"):
        x = _stale(x, L, rng, 0.08, 30)
    if kind == "outliers":
        # a tenth of the tiles each hold one atom carried across the x face
        xw = x - L * np.floor(x / L)
        top = np.argsort(-xw[:, 0])[:300]
        x[top[::10], 0] += 0.05 + L[0] - xw[top[::10], 0]
    _, xT = tsw.sorted_positions(torch.as_tensor(x), torch.as_tensor(box),
                                 perm.long(), n_pad, torch.float32)
    return xT, torch.as_tensor(L, dtype=torch.float32), n


RINGS = ["fresh", "stale", "small", "small-stale", "elongated", "ragged",
         "outliers"]


def _pairs_within_w(xT, L, n):
    """(i, j) of every pair (i, i + s), 1 <= s <= n_pad/2, of real slots with
    r^2 <= w^2 and r^2 > 1e-12, rounded as the plain bound rounds it."""
    n_pad = xT.shape[1]
    s = torch.arange(1, n_pad // 2 + 1)
    found = []
    for i0 in range(0, n, 512):
        i = torch.arange(i0, min(i0 + 512, n))[:, None]
        j = (i + s[None, :]) % n_pad
        _, r2 = tsw._pair_r2(xT, L, i.expand_as(j), j)
        hit = (r2 <= (CUTOFF + SKIN) ** 2) & (r2 > 1e-12) & (j < n)
        ii, jj = torch.nonzero(hit, as_tuple=True)
        found.append(torch.stack([i[ii, 0], j[ii, jj]], 1))
    return torch.cat(found)


@pytest.mark.parametrize("kind", RINGS)
def test_cull_never_skips_a_pair_within_w(kind):
    xT, L, n = _ring(kind)
    far = tsw.far_tiles(xT, L, n, CUTOFF, SKIN)
    pairs = _pairs_within_w(xT, L, n)
    assert pairs.shape[0] > 0
    assert not far[pairs[:, 0] // 32, pairs[:, 1] // 32].any()
    _, width = tsw.tile_arcs(xT, L, n)
    member = width >= 0
    culled = far[member][:, member].double().mean()
    if kind.startswith("small"):
        # L < 2 w: every pair of occupied tiles is in range
        assert float(culled) == 0.0
    else:
        # the rule is not vacuous: some in-range tiles never get tested
        assert float(culled) > 0.05


def test_tile_arcs_keep_crossed_atoms_and_drop_pad_slots():
    """An atom carried across the x face stays beside its tile's other
    members; pad slots, and slots of non-finite x, stay out of the arc; a
    tile without a member has width -1."""
    L = torch.tensor([3.0, 3.0, 3.0], dtype=torch.float32)
    x = torch.full((3, 128), 1e6, dtype=torch.float32)
    x[0, :32] = torch.linspace(2.90, 2.98, 32)
    x[0, 5] = 0.01                     # crossed the face: 3.01 - 3.0
    x[0, 32:64] = torch.linspace(1.0, 1.2, 32)
    x[0, 40] = float("nan")
    x[0, 64:70] = torch.linspace(0.5, 0.6, 6)   # real slots 64 .. 69
    start, width = tsw.tile_arcs(x, L, 70)
    assert start.dtype == width.dtype == torch.float32
    assert abs(float(start[0]) - 2.90) < 1e-6
    assert abs(float(width[0]) - 0.11) < 1e-5        # up to 3.01
    assert abs(float(width[1]) - 0.2) < 1e-5
    assert abs(float(start[2]) - 0.5) < 1e-6
    assert abs(float(width[2]) - 0.1) < 1e-5
    assert float(width[3]) == -1.0


def _scan(xT, L, n, share):
    """The bound kernel's second phase, one group after another: each group
    of 32 slots walks its partner tiles g + k from k = n_pad/64 down to 0,
    skips a culled tile, and stops once no nearer tile's largest shell lies
    in a block above the best found (its own, or with ``share`` every
    group's so far). Returns 1 + the best block and the tiles tested."""
    n_pad = xT.shape[1]
    tiles, half = n_pad // 32, n_pad // 2
    far = tsw.far_tiles(xT, L, n, CUTOFF, SKIN)
    lane = torch.arange(32)
    best, tested = -1, 0
    for g in range(tiles):
        top = best if share else -1
        for k in range(half // 32, -1, -1):
            if (min(32 * k + 31, half) - 1) // BS <= top:
                break
            if far[g, (g + k) % tiles]:
                continue
            tested += 1
            i = 32 * g + lane[:, None]
            p = 32 * (g + k) + lane[None, :]
            s, j = p - i, p % n_pad
            _, r2 = tsw._pair_r2(xT, L, i.expand(32, 32), j.expand(32, 32))
            hit = ((s >= 1) & (s <= half) & (i < n) & (j < n)
                   & (r2 <= (CUTOFF + SKIN) ** 2) & (r2 > 1e-12))
            if hit.any():
                top = max(top, int(((s[hit] - 1) // BS).max()))
        best = max(best, top)
    return best + 1, tested


@pytest.mark.parametrize("kind", RINGS)
def test_kernel_scan_gives_the_plain_bound(kind):
    xT, L, n = _ring(kind)
    ref = tsw.measure_bound_reference(
        xT, L, torch.tensor(True), torch.tensor(0, dtype=torch.int32), n=n,
        cutoff=CUTOFF, skin=SKIN, shell_block=BS)
    assert int(ref) > 0
    assert _scan(xT, L, n, share=False)[0] == _scan(xT, L, n, share=True)[0] \
        == int(ref)


@pytest.mark.parametrize("kind", RINGS)
def test_bound_floor_counts_no_more_than_the_scan_tests(kind):
    xT, L, n = _ring(kind)
    nb, alone = _scan(xT, L, n, share=False)
    _, shared = _scan(xT, L, n, share=True)
    k = SimpleNamespace(n=n, n_pad=xT.shape[1], rc=CUTOFF, skin=SKIN, bs=BS)
    floor = chip_smoke.bound_floor_tests(xT, L, k, nb)
    assert 0 <= floor <= 32 * 32 * min(alone, shared)
    if kind.startswith("small"):
        # the bound spans the ring: no tile lies above its last block
        assert floor == 0
