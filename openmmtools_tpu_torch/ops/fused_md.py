"""Cell-grid LJ BAOAB (counterpart of ``ops/pallas_md.py``).

:class:`FusedLJBAOAB` advances a monodisperse, uncharged, periodic LJ fluid
(cutoff and OpenMM's quintic switch, cubic box) by BAOAB ("V R O R V") on a
cell grid: every rebuild interval the particles are binned into slots of the
padded grid, one chunk of the interval runs on the slots, and the slots are
unbinned. It has the spec, the rebuild-interval rule and the ``run`` contract
of the TPU kernel ``openmmtools_tpu.ops.pallas_md.FusedLJBAOAB``:

    run(x, v, kT, generator, n_steps) -> (x, v)

with the noise seed of each chunk drawn from the caller's ``torch.Generator``
(which advances) in place of the returned key, and x as the last chunk left
it (the next bin wraps it).

Layout, as the JAX package's (so the tests compare like with like): slots
(3, M, G) on the padded (n_side + 2)^3 grid, M = ``capacity``, filled
rank-contiguously; empty slots hold the sentinels 1e5 + 7 slot (+3, +5) and
zero velocity; ``valid`` and ``slot_particle`` are (M, G). :func:`bin_particles`
/ :func:`unbin_particles` sort and scatter; :func:`bin_particles_matmul` /
:func:`unbin_particles_matmul` are the TPU's scatter-free one-hot products,
kept for parity. ``run`` takes the sort/scatter pair: at LJ-2048 the
one-hot E is 2048 x 16,000 float32 (131 MB), and scatters do not serialize
on the card as they do on the TPU.

On a CUDA tensor the forces and the chunk launch the hand-written kernels of
``csrc/cell_md.cu`` (built at first use by ``ops/_build.py``) or raise; on a
CPU tensor they run their plain versions, :func:`cell_forces_reference` and
:func:`cell_chunk_reference`, which draw the same Philox noise (counter: the
slot index m G + g and the step within the chunk); :func:`fused_lj_reference`
runs the whole of ``run`` on them on any device, the kernels' oracle on the
card.
``launches`` counts the kernels' launches, on CUDA tensors only.

Deliberate divergences from the TPU kernel:

* :func:`make_grid_spec` raises ``ValueError`` when a cell would be smaller
  than the cutoff (the JAX package's ``max(3, ...)`` makes such cells for
  boxes under 3 r_list, and its kernel then misses pairs);
* overflow is found at bin time, before the chunk: the bin's maximum
  occupancy is read on the host (one read a chunk), and a bin above the
  capacity is redone at capacity + 8 (``capacity_bumps`` counts it), where
  the JAX package runs the whole call, finds the overflow after it, and
  reruns it; the capacity is a runtime argument of the kernels, so nothing
  recompiles;
* the kernels visit only the occupied slots of each cell, so there is no
  dual 8-slot kernel: it existed because the TPU kernel's cost is linear in
  its static capacity;
* no energy, as the TPU kernel computes none.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from openmmtools_tpu_torch.ops._build import (
    check,
    check_input,
    kernels_for,
    load_library,
)
from openmmtools_tpu_torch.ops.fused_langevin import (
    draw_seed,
    lj_pair_reference,
    philox_normals,
)

__all__ = ["LJGridSpec", "make_grid_spec", "bin_particles",
           "unbin_particles", "bin_particles_matmul", "unbin_particles_matmul",
           "cell_forces_reference", "cell_chunk_reference", "FusedLJBAOAB",
           "fused_lj_reference"]

# pair_scale's lower bound on r^2 (pallas_md.py:356): self pairs drop out
R2_MIN = 1e-6


class LJGridSpec(NamedTuple):
    """Configuration of the cell grid and the fluid (the TPU kernel's)."""

    n_side: int          # interior cells per side
    capacity: int        # M: slots per cell
    box_edge: float      # L (cubic)
    cell_edge: float     # L / n_side (>= cutoff)
    cutoff: float
    switch_width: Optional[float]
    sigma: float
    epsilon: float
    mass: float
    timestep: float
    collision_rate: float

    @property
    def g_side(self) -> int:
        return self.n_side + 2

    @property
    def n_cells(self) -> int:
        return self.n_side ** 3

    @property
    def g_cells(self) -> int:
        return self.g_side ** 3


def make_grid_spec(n_particles, box_edge, cutoff, switch_width, sigma,
                   epsilon, mass, timestep, collision_rate,
                   skin_fraction=0.35, capacity=None) -> LJGridSpec:
    """The TPU kernel's grid for a fluid: cells of edge >= cutoff (1 +
    skin_fraction) where the box allows, at least 3 a side, and a capacity
    with Poisson-tail headroom over the mean occupancy, a multiple of 8.
    Raises ``ValueError`` when a cell would be smaller than the cutoff."""
    r_list = cutoff * (1.0 + skin_fraction)
    n_side = max(3, int(math.floor(box_edge / r_list)))
    cell_edge = box_edge / n_side
    if cell_edge < cutoff:
        raise ValueError(
            f"box edge {box_edge} gives cells of {cell_edge} < the cutoff "
            f"{cutoff} at 3 a side: a cell grid would miss pairs")
    if capacity is None:
        lam = n_particles / n_side**3
        capacity = int(math.ceil(lam + 4.0 * math.sqrt(lam) + 4))
        capacity = max(8, ((capacity + 7) // 8) * 8)
    return LJGridSpec(
        n_side=n_side, capacity=capacity, box_edge=float(box_edge),
        cell_edge=float(cell_edge), cutoff=float(cutoff),
        switch_width=None if switch_width is None else float(switch_width),
        sigma=float(sigma), epsilon=float(epsilon), mass=float(mass),
        timestep=float(timestep), collision_rate=float(collision_rate))


# ---------------------------------------------------------------------------
# binning
# ---------------------------------------------------------------------------


def _cells(x, spec: LJGridSpec):
    """x wrapped into the box and each particle's padded flat cell id."""
    L, ns, gs = spec.box_edge, spec.n_side, spec.g_side
    x_wrapped = x - L * torch.floor(x / L)
    cell = torch.clamp((x_wrapped / spec.cell_edge).to(torch.int64), 0, ns - 1)
    gflat = ((cell[:, 0] + 1) + gs * (cell[:, 1] + 1)
             + gs * gs * (cell[:, 2] + 1))
    return x_wrapped, gflat


def _sentinels(spec: LJGridSpec, device):
    """(3, M, G) far-away positions, distinct per slot, for empty slots."""
    m, g = spec.capacity, spec.g_cells
    s = 1.0e5 + 7.0 * torch.arange(m * g, dtype=torch.float32,
                                   device=device).reshape(m, g)
    return torch.stack([s, s + 3.0, s + 5.0])


def bin_particles(x, v, spec: LJGridSpec):
    """Sort particles (N, 3) into the padded cell grid.

    Returns (x_slots, v_slots, valid, slot_particle, max_occupancy):
    x_slots/v_slots (3, M, G) float32; valid (M, G) float32 mask;
    slot_particle (M, G) int32 particle index (-1 for empty); max_occupancy a
    0-dim tensor (particles beyond the capacity overwrite the cell's last
    slot, as on the TPU: the caller checks it)."""
    n = x.shape[0]
    m, g = spec.capacity, spec.g_cells
    x_wrapped, gflat = _cells(x, spec)
    order = torch.argsort(gflat, stable=True)
    sorted_g = gflat[order]
    # rank within cell = position - first occurrence of this cell id
    first = torch.searchsorted(sorted_g, sorted_g, side="left")
    rank = torch.arange(n, device=x.device) - first
    max_occ = torch.max(rank) + 1
    rank_c = torch.clamp(rank, max=m - 1)

    x_slots = _sentinels(spec, x.device)
    v_slots = torch.zeros((3, m, g), dtype=torch.float32, device=x.device)
    valid = torch.zeros((m, g), dtype=torch.float32, device=x.device)
    slot_particle = torch.full((m, g), -1, dtype=torch.int32, device=x.device)
    x_slots[:, rank_c, sorted_g] = x_wrapped[order].to(torch.float32).t()
    v_slots[:, rank_c, sorted_g] = v[order].to(torch.float32).t()
    valid[rank_c, sorted_g] = 1.0
    slot_particle[rank_c, sorted_g] = order.to(torch.int32)
    return x_slots, v_slots, valid, slot_particle, max_occ


def unbin_particles(x_slots, v_slots, slot_particle, n_particles):
    """Scatter slot arrays back to (N, 3) particle order."""
    flat_p = slot_particle.reshape(-1).to(torch.int64)
    # empty slots scatter to a spare row that is dropped, never to row 0
    idx = torch.where(flat_p >= 0, flat_p, n_particles)
    out = []
    for slots in (x_slots, v_slots):
        buf = torch.zeros((n_particles + 1, 3), dtype=slots.dtype,
                          device=slots.device)
        buf[idx] = slots.reshape(3, -1).t()
        out.append(buf[:n_particles])
    return tuple(out)


def bin_particles_matmul(x, v, spec: LJGridSpec):
    """Scatter-free binning: slot assignment by a one-hot matrix product
    (the TPU's form, where scatters serialize). Returns (x_slots, v_slots,
    valid, E, max_occupancy), with E (N, M G) reused by
    :func:`unbin_particles_matmul`. The rank within a cell is an (N, N)
    same-cell, lower-index count instead of a sort."""
    n = x.shape[0]
    m, g = spec.capacity, spec.g_cells
    x_wrapped, gflat = _cells(x, spec)
    idx = torch.arange(n, device=x.device)
    same = gflat[:, None] == gflat[None, :]
    rank = torch.sum(same & (idx[None, :] < idx[:, None]), dim=1)
    max_occ = torch.max(rank) + 1
    slot = rank * g + gflat   # >= M G when overflowing: the particle drops
    e = (slot[:, None] == torch.arange(m * g, device=x.device)[None, :]
         ).to(x_wrapped.dtype)
    xs = torch.einsum("nm,nc->mc", e, x_wrapped)
    vs = torch.einsum("nm,nc->mc", e, v.to(x_wrapped.dtype))
    valid = torch.sum(e, dim=0).reshape(m, g)
    x_slots = torch.where(valid[None] > 0, xs.t().reshape(3, m, g),
                          _sentinels(spec, x.device).to(xs.dtype))
    v_slots = vs.t().reshape(3, m, g) * valid[None]
    return (x_slots.to(torch.float32), v_slots.to(torch.float32),
            valid.to(torch.float32), e, max_occ)


def unbin_particles_matmul(x_slots, v_slots, e):
    """Inverse of the matmul binning: x = E @ slots."""
    x = e @ x_slots.reshape(3, -1).t().to(e.dtype)
    v = e @ v_slots.reshape(3, -1).t().to(e.dtype)
    return x, v


# ---------------------------------------------------------------------------
# plain PyTorch versions of the kernels
# ---------------------------------------------------------------------------


def _grid_geometry(spec: LJGridSpec, device):
    """The padded ids (ns^3,) of the interior cells, x fastest (the
    kernel's order), and for each of the 27 neighbour offsets in the
    kernel's order (dz, dy, dx each from -1 to 1) the neighbours' padded ids
    (ns^3,) and the coordinate shifts (3, ns^3) of their periodic images."""
    ns, gs, L = spec.n_side, spec.g_side, spec.box_edge
    ci = torch.arange(ns ** 3, device=device)
    c = (ci % ns + 1, (ci // ns) % ns + 1, ci // (ns * ns) + 1)
    interior = c[0] + gs * (c[1] + gs * c[2])
    neighbours = []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                nc, shift = [], []
                for a, d in zip(c, (dx, dy, dz)):
                    t = a + d
                    shift.append(torch.where(
                        t == 0, -L, torch.where(t == ns + 1, L, 0.0)))
                    nc.append(torch.where(
                        t == 0, ns, torch.where(t == ns + 1, 1, t)))
                neighbours.append((nc[0] + gs * (nc[1] + gs * nc[2]),
                                   torch.stack(shift).to(torch.float32)))
    return interior, neighbours


def cell_forces_reference(x_slots, valid, spec: LJGridSpec, rows=None):
    """Forces (3, M, G) of the slot positions: each valid interior slot
    against the valid slots of its cell and its 26 neighbours (periodic
    images by the coordinate shift), slot rows m < ``rows`` (default: all M;
    rows >= the largest occupancy gives the same forces). Zero in empty and
    ghost slots. The plain version of ``cell_forces_kernel``."""
    rows = spec.capacity if rows is None else int(rows)
    interior, neighbours = _grid_geometry(spec, x_slots.device)
    xi = x_slots[:, :rows, interior]                          # (3, R, C)
    vi = valid[:rows, interior] > 0
    rc = spec.cutoff
    F = torch.zeros_like(xi)
    for gn, shift in neighbours:
        xj = x_slots[:, :rows, gn] + shift[:, None, :]
        vj = valid[:rows, gn] > 0
        d = xi[:, :, None, :] - xj[:, None, :, :]             # (3, R, R, C)
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        mask = ((r2 < rc * rc) & (r2 > R2_MIN) & vi[:, None, :]
                & vj[None, :, :])
        w, _ = lj_pair_reference(r2, mask, cutoff=rc,
                                 switch_width=spec.switch_width,
                                 sigma=spec.sigma, epsilon=spec.epsilon)
        F = F + torch.sum(w[None] * d, dim=2)
    out = torch.zeros_like(x_slots)
    out[:, :rows, interior] = F * vi
    return out


def _integrator_constants(spec: LJGridSpec):
    """(half_dt, kick = half_dt / mass, ou_a, ou_b, inv_m) of one BAOAB step
    (the TPU kernel's, pallas_md.py:287-291)."""
    dt = spec.timestep
    ou_a = math.exp(-spec.collision_rate * dt)
    ou_b = math.sqrt(max(0.0, 1.0 - ou_a * ou_a))
    inv_m = 1.0 / spec.mass
    return 0.5 * dt, 0.5 * dt * inv_m, ou_a, ou_b, inv_m


def cell_chunk_reference(x_slots, v_slots, valid, kT, seed, n_steps,
                         spec: LJGridSpec, rows=None):
    """``n_steps`` of "V R O R [forces] V" on the slots: the plain version of
    ``cell_chunk_kernel`` (after ``cell_forces_kernel`` starts it). O draws
    philox_normals with counter (m G + g, step, 0, 0) under ``seed``.
    Returns (x_slots, v_slots)."""
    half_dt, kick, ou_a, ou_b, inv_m = _integrator_constants(spec)
    m, g = spec.capacity, spec.g_cells
    x, v = x_slots, v_slots
    sig = ou_b * torch.sqrt(torch.as_tensor(kT, dtype=torch.float32,
                                            device=x.device) * inv_m)
    F = cell_forces_reference(x, valid, spec, rows)
    for step in range(int(n_steps)):
        v = v + kick * F                                      # V
        x = x + half_dt * v                                   # R
        if ou_b != 0.0:                                       # O
            z = philox_normals(m * g, seed, step, 0, x.device).reshape(3, m, g)
            v = (ou_a * v + sig * z) * valid
        elif ou_a != 1.0:
            v = ou_a * v
        x = x + half_dt * v                                   # R
        F = cell_forces_reference(x, valid, spec, rows)
        v = v + kick * F                                      # V
    return x, v


def _occupancy(valid):
    """(G,) int32 count of the occupied slots of each cell."""
    return torch.sum(valid > 0, dim=0, dtype=torch.int32)


# ---------------------------------------------------------------------------
# the loop over rebuild intervals
# ---------------------------------------------------------------------------


class FusedLJBAOAB:
    """Cell-grid BAOAB: bin, one chunk a rebuild interval, unbin.

    ``rebuild_interval`` defaults to the TPU version's rule (half the skin
    over four thermal velocities' drift a step, 1 to 200 steps, at
    ``temperature``, default 300 K). ``capacity_bumps`` counts the capacity
    increases; ``max_occupancy`` is the largest cell occupancy the last
    :meth:`run` binned.
    """

    def __init__(self, spec: LJGridSpec, n_particles: int,
                 rebuild_interval: Optional[int] = None, temperature=None,
                 device="cuda"):
        self.spec = spec
        self.n_particles = int(n_particles)
        if rebuild_interval is None:
            kT_guess = 0.008314 * float(temperature or 300.0)
            v_th = math.sqrt(kT_guess / spec.mass)
            skin = spec.cell_edge - spec.cutoff
            drift = 4.0 * v_th * spec.timestep
            rebuild_interval = max(1, min(200, int(0.5 * skin
                                                   / max(drift, 1e-12))))
        self.rebuild_interval = int(rebuild_interval)
        self.device = torch.device(device)
        self.launches = {"cell_forces": 0, "cell_chunk": 0}
        self.capacity_bumps = 0
        self.max_occupancy = 0

    def _physics(self):
        sw = self.spec.switch_width
        rc = self.spec.cutoff
        return (rc * rc, self.spec.sigma ** 2, 4.0 * self.spec.epsilon,
                24.0 * self.spec.epsilon, 0.0 if sw is None else rc - sw,
                0.0 if sw is None else 1.0 / sw, int(sw is not None))

    def _check_slots(self, *slots, valid):
        shape = (3, self.spec.capacity, self.spec.g_cells)
        for t in slots:
            check_input(t, torch.float32, shape)
        check_input(valid, torch.float32, shape[1:])

    def _launch_forces(self, x_slots, occ, rows, F):
        spec = self.spec
        err = load_library().cell_forces_f32(
            x_slots.data_ptr(), occ.data_ptr(), spec.n_side, spec.capacity,
            rows, spec.box_edge, *self._physics(), F.data_ptr(),
            torch.cuda.current_stream(x_slots.device).cuda_stream)
        self.launches["cell_forces"] += 1
        check(err, "cell_forces_f32")

    def forces(self, x_slots, valid, rows=None):
        """Forces (3, M, G) of the slot positions (the TPU kernel's
        ``forces_only`` variant), slot rows m < ``rows`` (default M)."""
        rows = self.spec.capacity if rows is None else int(rows)
        if not kernels_for(x_slots, "cell-grid LJ kernel"):
            return cell_forces_reference(x_slots, valid, self.spec, rows)
        self._check_slots(x_slots, valid=valid)
        F = torch.zeros_like(x_slots)
        self._launch_forces(x_slots, _occupancy(valid), rows, F)
        return F

    def chunk(self, x_slots, v_slots, valid, kT, seed, n_steps, rows=None):
        """``n_steps`` of BAOAB on binned slots; returns (x_slots, v_slots),
        updated in place on the card. ``kT`` is a (1,) float32 tensor."""
        rows = self.spec.capacity if rows is None else int(rows)
        if not kernels_for(x_slots, "cell-grid LJ kernel"):
            return cell_chunk_reference(x_slots, v_slots, valid, kT, seed,
                                        n_steps, self.spec, rows)
        self._check_slots(x_slots, v_slots, valid=valid)
        check_input(kT, torch.float32, (1,))
        spec = self.spec
        occ = _occupancy(valid)
        F = torch.zeros_like(x_slots)
        self._launch_forces(x_slots, occ, rows, F)
        xb = torch.empty_like(x_slots)
        err = load_library().cell_chunk_f32(
            x_slots.data_ptr(), xb.data_ptr(), v_slots.data_ptr(),
            F.data_ptr(), occ.data_ptr(), kT.data_ptr(), spec.n_side,
            spec.capacity, rows, spec.box_edge, int(n_steps),
            *self._physics(), *_integrator_constants(spec), seed,
            torch.cuda.current_stream(x_slots.device).cuda_stream)
        self.launches["cell_chunk"] += 1
        check(err, "cell_chunk_f32")
        return x_slots, v_slots

    def bin(self, x, v):
        """:func:`bin_particles` with the overflow check: the maximum
        occupancy is read on the host, and while it exceeds the capacity the
        capacity grows by 8 and the bin is redone. Returns (x_slots,
        v_slots, valid, slot_particle, max_occupancy as an int)."""
        while True:
            x_s, v_s, valid, slot_particle, max_occ = bin_particles(
                x, v, self.spec)
            max_occ = int(max_occ)
            if max_occ <= self.spec.capacity:
                return x_s, v_s, valid, slot_particle, max_occ
            while self.spec.capacity < max_occ:
                self.spec = self.spec._replace(
                    capacity=self.spec.capacity + 8)
                self.capacity_bumps += 1

    def run(self, x, v, kT, generator, n_steps: int):
        """Advance (x, v) (N, 3) by ``n_steps`` in chunks of the rebuild
        interval, then the remainder; returns float32 (x, v)."""
        return self._run(x, v, kT, generator, n_steps, self.chunk)

    def _run(self, x, v, kT, generator, n_steps, chunk):
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        v = torch.as_tensor(v, dtype=torch.float32, device=self.device)
        kT = torch.as_tensor(kT).to(device=self.device,
                                    dtype=torch.float32).reshape(1)
        n_chunks, remainder = divmod(int(n_steps), self.rebuild_interval)
        self.max_occupancy = 0
        for steps in [self.rebuild_interval] * n_chunks + (
                [remainder] if remainder else []):
            x_s, v_s, valid, slot_particle, max_occ = self.bin(x, v)
            self.max_occupancy = max(self.max_occupancy, max_occ)
            x_s, v_s = chunk(x_s, v_s, valid, kT, draw_seed(generator), steps,
                             rows=max_occ)
            x, v = unbin_particles(x_s, v_s, slot_particle, self.n_particles)
        return x, v


def fused_lj_reference(program: FusedLJBAOAB, x, v, kT, generator, n_steps):
    """The plain PyTorch version of ``program.run`` on any device: the same
    bins and seeds, each chunk by :func:`cell_chunk_reference`."""
    def chunk(x_s, v_s, valid, kT, seed, steps, rows):
        return cell_chunk_reference(x_s, v_s, valid, kT, seed, steps,
                                    program.spec, rows)

    return program._run(x, v, kT, generator, n_steps, chunk)
