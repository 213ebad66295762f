"""Fused Langevin splitting + LJ fluid chunk (counterpart of
``ops/pallas_baoab.py``).

:class:`FusedSortedLangevin` advances ``n_steps`` of any R/V/O splitting
("V R O R V" = BAOAB, "O V R V O" = VVVR, "V R R O R R V" = g-BAOAB,
"V R V" = velocity Verlet) for a monodisperse, uncharged, periodic LJ fluid
with cutoff and OpenMM's quintic switch, minimum-image orthorhombic PBC. It
has the physics arguments and the ``run`` contract of the TPU kernel
``openmmtools_tpu.ops.pallas_baoab.FusedSortedLangevin``:

    run(x, v, box, kT, generator, n_steps) -> (x, v, F, U)

with x wrapped into [0, L), F and U those of the returned positions, box and
kT read at run time, and the noise seed drawn from the caller's
``torch.Generator`` on each call.

On a CUDA tensor a chunk is one launch of the persistent cooperative
kernel of ``csrc/dense_baoab.cu`` (built at first use by ``ops/_build.py``)
or raises: the step program of the splitting goes to the kernel as a small
table, and the kernel walks it once a step. On a CPU tensor it runs the
plain version, :func:`fused_langevin_reference`: a host loop over
:func:`lj_forces_reference` and :func:`langevin_substep_reference` that
walks the same program, on any device; it is the kernel's oracle on the
card. The plain versions draw the same Philox4x32-10 noise as the kernel,
so on one seed the two agree to float32 rounding even with noise.
:meth:`FusedSortedLangevin.forces` is one force evaluation alone
(``csrc/fused_langevin.cu``).

The step program follows the TPU kernel's lazy-sweep rule (pallas_baoab.py
:712-741): one sweep at chunk start, one before the first V after any R,
one at step end if positions moved, so most splittings cost one sweep per
step. Substep sizes are dt/n_R, dt/n_V and dt/n_O.

The TPU kernel's sorted ring, shell bound and Verlet-skin rebuild have no
counterpart in this all-pairs design, so neither has its ``last_stats``
(rebuild count, shell bound); only the TPU tuning scripts read those. The
measurement-only knobs ``rsqrt_newton``/``bf16_mask`` are not ported.
``launches`` counts kernel launches per kernel, on CUDA tensors only:
``lj_chunk`` a chunk, ``lj_forces`` a force evaluation.

:class:`FusedDenseBAOAB` is the counterpart of the TPU kernel
``openmmtools_tpu.ops.pallas_baoab.FusedDenseBAOAB`` (K3): BAOAB ("V R O R
V") over all pairs, a whole chunk in one launch of the same chunk kernel.
Its plain version is :func:`fused_langevin_reference` of a "V R O R V"
:class:`FusedSortedLangevin`, the same Philox stream included.
"""
from __future__ import annotations

import ctypes
import math

import torch

from openmmtools_tpu_torch.ops._build import (
    check,
    check_input,
    kernels_for,
    load_library,
)

__all__ = ["FusedSortedLangevin", "FusedSortedBAOAB", "FusedDenseBAOAB",
           "brings_own_step", "fits_chunk_table", "fused_langevin_reference", "lj_forces_reference",
           "lj_pair_reference", "langevin_substep_reference",
           "philox_normals"]

_TOKEN_CODE = {"R": 0, "V": 1, "O": 2}
_MAX_SEGMENT = 16  # 2 bits a token in a uint32
# the chunk kernel's step-program table (csrc/dense_baoab.cu MAX_ITEMS,
# SWEEP)
_MAX_ITEMS = 16
_SWEEP = 1

# ---------------------------------------------------------------------------
# Philox4x32-10 in plain PyTorch (bit-identical to the kernel's)
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo32(m: int, c: torch.Tensor):
    """(hi, lo) 32-bit halves of m * c for int64 tensors c < 2^32, in
    16-bit pieces so no int64 product overflows."""
    a = c * (m & 0xFFFF)
    b = c * (m >> 16)
    lo_full = a + ((b & 0xFFFF) << 16)
    return (b >> 16) + (lo_full >> 32), lo_full & _MASK32


def _philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo32(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _bits_to_uniform(r):
    # 23 random bits -> (0, 1), never 0; exact in float32
    return (r >> 9).to(torch.float32) * (1.0 / 8388608.0) + (0.5 / 8388608.0)


def philox_normals(n: int, seed: int, step: int, o_index: int, device):
    """(3, n) standard normals of O-token ``o_index`` in ``step``: Box–Muller
    over Philox4x32-10 with counter (particle, step, o_index, 0) and the
    64-bit ``seed`` as key."""
    c0 = torch.arange(n, dtype=torch.int64, device=device)
    full = lambda value: torch.full_like(c0, value)  # noqa: E731
    r = _philox4x32_10(c0, full(step & _MASK32), full(o_index & _MASK32),
                       full(0), seed & _MASK32, (seed >> 32) & _MASK32)
    u0, u1, u2, u3 = (_bits_to_uniform(t) for t in r)
    two_pi = 2.0 * math.pi
    rad01 = torch.sqrt(-2.0 * torch.log(u0))
    rad23 = torch.sqrt(-2.0 * torch.log(u2))
    return torch.stack([rad01 * torch.cos(two_pi * u1),
                        rad01 * torch.sin(two_pi * u1),
                        rad23 * torch.cos(two_pi * u3)])


# ---------------------------------------------------------------------------
# plain PyTorch versions of the kernels' parts (layout (3, n), float32)
# ---------------------------------------------------------------------------


def lj_pair_reference(r2, mask, *, cutoff, switch_width, sigma, epsilon):
    """(w, e) of the pairs at squared distances ``r2`` where ``mask`` holds,
    0 elsewhere: the force on i is w * (x_i - x_j), e the pair energy. The
    plain version of lj_common.cuh ``pair``."""
    # masking flows through inv_r: zero kills every term below
    inv_r = torch.where(mask, torch.rsqrt(torch.where(mask, r2, 1.0)), 0.0)
    inv_r2 = inv_r * inv_r
    s2 = (sigma * sigma) * inv_r2
    s6 = s2 * s2 * s2
    s12 = s6 * s6
    e = (4.0 * epsilon) * (s12 - s6)
    w = (24.0 * epsilon) * (2.0 * s12 - s6) * inv_r2
    if switch_width is not None:
        inv_span = 1.0 / switch_width
        r = r2 * inv_r
        t = torch.clamp((r - (cutoff - switch_width)) * inv_span, min=0.0)
        S = 1.0 + t * t * t * (-10.0 + t * (15.0 - 6.0 * t))
        omt = 1.0 - t
        dS = (-30.0 * inv_span) * (t * t) * (omt * omt)
        w = w * S - e * dS * inv_r
        e = e * S
    return w, e


def lj_forces_reference(xT, L, *, cutoff, switch_width, sigma, epsilon):
    """Forces (3, n) and energy () of positions ``xT`` (3, n) in a box of
    diagonal ``L`` (3,): the plain version of ``lj_forces_kernel`` and of
    the chunk kernel's sweep."""
    ds = []
    r2 = None
    for c in range(3):
        d = xT[c][:, None] - xT[c][None, :]
        d = d - L[c] * torch.round(d * (1.0 / L[c]))
        ds.append(d)
        r2 = d * d if r2 is None else r2 + d * d
    mask = (r2 < cutoff * cutoff) & (r2 > 1e-12)
    w, e = lj_pair_reference(r2, mask, cutoff=cutoff,
                             switch_width=switch_width, sigma=sigma,
                             epsilon=epsilon)
    F = torch.stack([torch.sum(w * d, dim=1) for d in ds])
    return F, 0.5 * torch.sum(e)


def langevin_substep_reference(xT, vT, F, L, kT, tokens, *, h_R, hv_inv_m,
                               ou_a, ou_b, inv_m, seed, step, o_base, wrap):
    """One run of R/V/O ``tokens`` on (3, n) positions and velocities: the
    plain version of the chunk kernel's segment. Returns (x, v)."""
    x, v = xT, vT
    sig = ou_b * torch.sqrt(kT * inv_m)
    o_index = o_base
    for tok in tokens:
        if tok == "R":
            x = x + h_R * v
        elif tok == "V":
            v = v + hv_inv_m * F
        else:
            if ou_b != 0.0:
                z = philox_normals(x.shape[1], seed, step, o_index, x.device)
                v = ou_a * v + sig * z
            elif ou_a != 1.0:
                v = ou_a * v
            o_index += 1
    if wrap:
        Lc = L[:, None]
        x = x - Lc * torch.floor(x * (1.0 / Lc))
    return x, v


def _step_program(tokens):
    """One step's token string cut at its force sweeps by the lazy rule:
    a list of ("sub", tokens, o_base, wrap) and ("sweep",) items."""
    program = []
    seg, seg_o_base, n_o, stale = [], 0, 0, False
    for tok in tokens:
        if tok == "V" and stale:
            program += [("sub", tuple(seg), seg_o_base, True), ("sweep",)]
            seg, seg_o_base, stale = [], n_o, False
        stale = stale or tok == "R"
        n_o += tok == "O"
        seg.append(tok)
    if seg:
        program.append(("sub", tuple(seg), seg_o_base, stale))
    if stale:
        program.append(("sweep",))
    return program


def _longest_segment(program):
    return max((len(item[1]) for item in program if item[0] == "sub"),
               default=0)


def fits_chunk_table(tokens) -> bool:
    """Whether the chunk kernel's table holds the step program of
    ``tokens``: at most ``_MAX_ITEMS`` items and at most ``_MAX_SEGMENT``
    tokens between force sweeps. A splitting that does not fit takes the
    generic step program."""
    program = _step_program(tuple(tokens))
    return (len(program) <= _MAX_ITEMS
            and _longest_segment(program) <= _MAX_SEGMENT)


def brings_own_step(bound_class) -> bool:
    """Whether a bound-integrator class replaces ``BoundIntegrator``'s step
    program: it overrides ``step`` or ``initial_state``, as the integrators
    of ``integrators/extras.py`` do (Andersen collisions, the HMC and
    Metropolis accept/reject, the Nosé–Hoover chain, the no-op). The chunk
    kernel runs only the step program of R/V/O tokens, so such a class
    never takes it, whatever its splitting; nor the trailing velocity
    projection skip, which only that program's own steps make good."""
    from openmmtools_tpu_torch.integrators.langevin import BoundIntegrator

    return any(getattr(bound_class, name) is not getattr(BoundIntegrator, name)
               for name in ("step", "initial_state"))


def _program_table(program):
    """The step program as the chunk kernel's table (csrc/dense_baoab.cu):
    5 uint32 words an item, (kind, n_tok, tok_code, o_base, wrap), kind 0 a
    segment whose tokens take 2 bits each in tok_code and kind 1
    (``_SWEEP``) a sweep with the other words 0. Raises past ``_MAX_ITEMS``
    items or ``_MAX_SEGMENT`` tokens a segment."""
    if _longest_segment(program) > _MAX_SEGMENT:
        raise ValueError(
            f"more than {_MAX_SEGMENT} tokens between force sweeps")
    if len(program) > _MAX_ITEMS:
        raise ValueError(f"a step program of {len(program)} items: the "
                         f"chunk kernel takes at most {_MAX_ITEMS}")
    words = []
    for item in program:
        if item[0] == "sweep":
            words += [_SWEEP, 0, 0, 0, 0]
        else:
            _, toks, o_base, wrap = item
            code = sum(_TOKEN_CODE[t] << (2 * k) for k, t in enumerate(toks))
            words += [0, len(toks), code, o_base, int(wrap)]
    return words


def draw_seed(generator: torch.Generator) -> int:
    """A 63-bit seed from the caller's generator (one host read)."""
    return int(torch.randint(0, 2**63 - 1, (1,), generator=generator,
                             device=generator.device).item())


def _device_inputs(n, x, v, box, kT, device):
    """(N, 3) x and v as fresh contiguous (3, N) float32 buffers, the box
    diagonal L (3,) and kT (1,), all on ``device``."""
    xT = torch.empty((3, n), dtype=torch.float32, device=device)
    vT = torch.empty_like(xT)
    xT.copy_(torch.as_tensor(x).detach().t())
    vT.copy_(torch.as_tensor(v).detach().t())
    L = torch.diagonal(torch.as_tensor(box)).to(
        device=device, dtype=torch.float32).contiguous()
    kT = torch.as_tensor(kT).to(device=device, dtype=torch.float32).reshape(1)
    return xT, vT, L, kT


class FusedSortedLangevin:
    """Fused R/V/O-splitting + LJ chunk program for one fluid configuration.

    Physics arguments as the TPU kernel's; box and kT are runtime inputs of
    :meth:`run`, never baked in.
    """

    def __init__(self, n_particles, cutoff, switch_width, sigma, epsilon,
                 mass, timestep, collision_rate,
                 tokens=("V", "R", "O", "R", "V")):
        self.n = int(n_particles)
        self.rc = float(cutoff)
        self.switch_width = (None if switch_width is None
                             else float(switch_width))
        self.sigma = float(sigma)
        self.epsilon = float(epsilon)
        self.mass = float(mass)
        self.dt = float(timestep)
        self.gamma = float(collision_rate)
        self.tokens = tuple(t.upper() for t in tokens)
        if not set(self.tokens) <= set(_TOKEN_CODE):
            raise ValueError("fused kernel supports R/V/O tokens only")
        n_R = max(1, self.tokens.count("R"))
        n_V = max(1, self.tokens.count("V"))
        n_O = max(1, self.tokens.count("O"))
        self.inv_m = 1.0 / self.mass
        self.h_R = self.dt / n_R
        self.hv_inv_m = (self.dt / n_V) * self.inv_m
        h_O = self.dt / n_O
        self.ou_a = math.exp(-self.gamma * h_O)
        self.ou_b = math.sqrt(1.0 - math.exp(-2.0 * self.gamma * h_O))
        self.program = _step_program(self.tokens)
        self.table = _program_table(self.program)
        self.launches = {"lj_forces": 0, "lj_chunk": 0}
        self._tickets = {}   # device -> lj_forces_f32's ticket, kept at 0

    def _physics(self):
        return dict(cutoff=self.rc, switch_width=self.switch_width,
                    sigma=self.sigma, epsilon=self.epsilon)

    def _pair_args(self):
        """The pair term's arguments of the C entry points."""
        sw = self.switch_width
        return (self.rc * self.rc, self.sigma * self.sigma,
                4.0 * self.epsilon, 24.0 * self.epsilon,
                0.0 if sw is None else self.rc - sw,
                0.0 if sw is None else 1.0 / sw, int(sw is not None))

    def _substep_args(self, seed, step, o_base, wrap):
        return dict(h_R=self.h_R, hv_inv_m=self.hv_inv_m, ou_a=self.ou_a,
                    ou_b=self.ou_b, inv_m=self.inv_m, seed=seed, step=step,
                    o_base=o_base, wrap=wrap)

    def forces(self, xT, L):
        """Forces (3, n) and energy (1,) of positions ``xT`` (3, n) float32:
        one launch of ``lj_forces_kernel`` on a CUDA tensor."""
        if not kernels_for(xT, "fused Langevin kernel"):
            F, U = lj_forces_reference(xT, L, **self._physics())
            return F, U.reshape(1)
        check_input(xT, torch.float32, (3, self.n))
        check_input(L, torch.float32, (3,))
        ticket = self._tickets.get(xT.device)
        if ticket is None:
            ticket = self._tickets[xT.device] = torch.zeros(
                1, dtype=torch.int32, device=xT.device)
        F, U = torch.empty_like(xT), xT.new_empty(1)
        err = load_library().lj_forces_f32(
            xT.data_ptr(), self.n, L.data_ptr(), *self._pair_args(),
            F.data_ptr(), xT.new_empty(self.n).data_ptr(), ticket.data_ptr(),
            U.data_ptr(), torch.cuda.current_stream(xT.device).cuda_stream)
        self.launches["lj_forces"] += 1
        check(err, "lj_forces_f32")
        return F, U

    def run(self, x, v, box, kT, generator, n_steps):
        """Advance (x, v) (N, 3) by ``n_steps``; returns float32
        (x, v, F, U), x wrapped into the box. The seed is drawn from
        ``generator``, which advances."""
        return self.chunk(x, v, box, kT, draw_seed(generator), n_steps)

    def chunk(self, x, v, box, kT, seed, n_steps):
        """:meth:`run` with an explicit 63-bit ``seed``: one launch of the
        chunk kernel on a CUDA tensor, its plain version on a CPU tensor."""
        if not kernels_for(x, "fused Langevin kernel"):
            return fused_langevin_reference(self, x, v, box, kT, seed,
                                            n_steps)
        return self._launch_chunk(x, v, box, kT, seed, n_steps,
                                  self.launches, "lj_chunk")

    def _launch_chunk(self, x, v, box, kT, seed, n_steps, launches, key):
        """One launch of ``lj_chunk_kernel`` (csrc/dense_baoab.cu) for
        ``n_steps`` of this program, counted in ``launches[key]``."""
        n = self.n
        xT, vT, L, kT = _device_inputs(n, x, v, box, kT, x.device)
        F, xb = torch.empty_like(xT), torch.empty_like(xT)
        U, partial = xT.new_empty(1), xT.new_empty(n)
        table = (ctypes.c_uint32 * len(self.table))(*self.table)
        err = load_library().lj_chunk_f32(
            xT.data_ptr(), vT.data_ptr(), xb.data_ptr(), F.data_ptr(),
            partial.data_ptr(), U.data_ptr(), L.data_ptr(), kT.data_ptr(), n,
            int(n_steps), table, len(self.program), *self._pair_args(),
            self.h_R, self.hv_inv_m, self.ou_a, self.ou_b, self.inv_m, seed,
            torch.cuda.current_stream(x.device).cuda_stream)
        launches[key] += 1
        check(err, "lj_chunk_f32")
        return xT.t().contiguous(), vT.t().contiguous(), F.t().contiguous(), U[0]


def fused_langevin_reference(program: FusedSortedLangevin, x, v, box, kT,
                             seed, n_steps):
    """The plain PyTorch version of the whole chunk, on any device: a host
    loop over :func:`lj_forces_reference` and
    :func:`langevin_substep_reference` that walks ``program``'s step
    program, with an explicit ``seed`` in place of the generator draw.
    Returns float32 (x, v, F, U) as :meth:`FusedSortedLangevin.run`."""
    physics = program._physics()
    xT, vT, L, kT = _device_inputs(program.n, x, v, box, kT, x.device)

    def substep(tokens, step, o_base, wrap):
        return langevin_substep_reference(
            xT, vT, F, L, kT, tokens,
            **program._substep_args(seed, step, o_base, wrap))

    # chunk start: wrap (no tokens, so F is not read), sweep
    F = None
    xT, vT = substep((), 0, 0, True)
    F, U = lj_forces_reference(xT, L, **physics)
    for step in range(int(n_steps)):
        for item in program.program:
            if item[0] == "sweep":
                F, U = lj_forces_reference(xT, L, **physics)
            else:
                _, toks, o_base, wrap = item
                xT, vT = substep(toks, step, o_base, wrap)
    return xT.t().contiguous(), vT.t().contiguous(), F.t().contiguous(), U


# backward-compatible name (tokens default to BAOAB)
FusedSortedBAOAB = FusedSortedLangevin


class FusedDenseBAOAB:
    """Fused BAOAB + all-pairs LJ chunk program for one fluid configuration:
    the port of the TPU kernel ``FusedDenseBAOAB``.

    Physics arguments as the TPU kernel's; box and kT are runtime inputs of
    :meth:`run`. The TPU kernel's ``shell_block`` (its shell tiling of the
    lane axis) and ``interpret`` (its CPU mode) have no counterpart: a CPU
    tensor runs the plain chunk. On a CUDA tensor a chunk is one launch of
    the chunk kernel K1's wrapper launches, with the tokens "V R O R V";
    ``launches`` counts them, on CUDA tensors only.
    """

    def __init__(self, n_particles, cutoff, switch_width, sigma, epsilon,
                 mass, timestep, collision_rate, device="cuda"):
        self.program = FusedSortedLangevin(
            n_particles, cutoff, switch_width, sigma, epsilon, mass,
            timestep, collision_rate, tokens=("V", "R", "O", "R", "V"))
        self.n = self.program.n
        self.device = torch.device(device)
        self.launches = {"dense_baoab": 0}

    def run(self, x, v, box, kT, generator, n_steps):
        """Advance (x, v) (N, 3) by ``n_steps``; returns float32 (x, v, F, U)
        with x wrapped into the box and F, U those of the returned x. The
        seed is drawn from ``generator``, which advances."""
        return self.chunk(x, v, box, kT, draw_seed(generator), n_steps)

    def chunk(self, x, v, box, kT, seed, n_steps):
        """:meth:`run` with an explicit 63-bit ``seed``."""
        x = torch.as_tensor(x, device=self.device)
        v = torch.as_tensor(v, device=self.device)
        box = torch.as_tensor(box, device=self.device)
        if not kernels_for(x, "dense BAOAB kernel"):
            return fused_langevin_reference(self.program, x, v, box, kT,
                                            seed, n_steps)
        return self.program._launch_chunk(x, v, box, kT, seed, n_steps,
                                          self.launches, "dense_baoab")
