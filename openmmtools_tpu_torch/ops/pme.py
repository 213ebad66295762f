"""Ewald reciprocal space as factorized structure factors (counterpart of
``ops/pme.py``).

The direct k-space Ewald sum, with the structure factor
S(k) = sum_j q_j exp(i k . r_j) factorized per axis so that the heavy work is
one matrix product in each direction:

    E_rec = k_e * (2 pi / V) sum_{k != 0} exp(-k^2/(4 alpha^2))/k^2 |S(k)|^2
    E_self = -k_e * alpha/sqrt(pi) sum_j q_j^2
    E_excl = -k_e * sum_{excluded pairs} q_i q_j erf(alpha r_ij)/r_ij

combined with the erfc direct-space term of the nonbonded pair paths
(method='pme'/'ewald'). Alpha and the k-space extent follow OpenMM's
error-tolerance heuristics: alpha = sqrt(-ln(2 tol))/cutoff,
n_max = ceil(alpha L sqrt(-ln(2 tol)) / pi).

None of this is a Pallas kernel in the JAX package: the contractions are
einsums left to XLA there and to ``torch.einsum`` here, in full float32 on
the card (the package switches TF32 off at import). The real-basis structure
factor carries its hand-written backward (a ``torch.autograd.Function``),
including the cotangent of the k-space weight grid, so box derivatives stay
exact; the complex Hermitian-half form is kept as its oracle and
differentiates by autograd.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from openmmtools_tpu_torch.constants import ONE_4PI_EPS0
from openmmtools_tpu_torch.utils import tracing
from openmmtools_tpu_torch.utils.pytree import static_field, tensor_dataclass

# OpenMM NonbondedForce's default PME tolerance. openmmtools' test systems
# ask for 1e-5 instead; builders take a tol argument.
DEFAULT_EWALD_ERROR_TOLERANCE = 5e-4


def ewald_alpha(cutoff: float, tol: float = DEFAULT_EWALD_ERROR_TOLERANCE
                ) -> float:
    """OpenMM's alpha heuristic: sqrt(-ln(2 tol)) / cutoff."""
    return math.sqrt(-math.log(2.0 * tol)) / cutoff


def ewald_kmax(alpha: float, box_edge: float,
               tol: float = DEFAULT_EWALD_ERROR_TOLERANCE) -> int:
    """Number of reciprocal lattice shells per axis."""
    return max(1, int(math.ceil(alpha * box_edge
                                * math.sqrt(-math.log(2.0 * tol)) / math.pi)))


# ---------------------------------------------------------------------------
# complex Hermitian-half structure factors (the tests' oracle of the real
# basis below, which the factorized path uses)
# ---------------------------------------------------------------------------


def _phase_tables(theta, M, half=False):
    """(N, 2M+1) complex phase tables exp(i m theta), m = -M..M; with
    ``half`` only m = 0..M (real charges: S(-k) = conj(S(k)))."""
    lo = 0 if half else -M
    mj = torch.arange(lo, M + 1, dtype=theta.dtype, device=theta.device)
    th = theta[:, None] * mj[None, :]
    return torch.complex(torch.cos(th), torch.sin(th))


def _sf_weighted_sum(q, tx, ty, tz, w, M):
    """W = sum_k w(k) |S(k)|^2 over the Hermitian HALF cube kx = 0..M,
    ky, kz = -M..M, the factor 2 for kx > 0 folded into ``w`` by the caller
    (shape (M+1, 2M+1, 2M+1))."""
    S = torch.einsum('n,nx,ny,nz->xyz',
                     torch.complex(q, torch.zeros_like(q)),
                     _phase_tables(tx, M, half=True),
                     _phase_tables(ty, M), _phase_tables(tz, M))
    return torch.sum(w * (S.real ** 2 + S.imag ** 2))


# ---------------------------------------------------------------------------
# real-basis (parity-folded) structure factors
# ---------------------------------------------------------------------------
#
# w(k) is even in ky and kz separately, and the sum of |S|^2 over the four
# (+-ky, +-kz) sign combinations diagonalizes in the cos/sin basis:
#
#   S(kx, +-my, +-mz) = T1 -+ T4 + i(+-T2 +-T3)  with
#   T1 = sum q Px Cy Cz,  T2 = sum q Px Cy Sz,  T3 = sum q Px Sy Cz,
#   T4 = sum q Px Sy Sz
#   sum over the signs of |S|^2 = 4 (|T1|^2 + |T2|^2 + |T3|^2 + |T4|^2)
#
# so with stacked real tables X = [cos, sin](N, 2(M+1)) per axis, ONE real
# einsum T[x2, yb, zb] = sum_n (q X)(Y (x) Z) and
# W = sum tile(w wy wz, (2,2,2)) T^2 replace the complex contraction.


def _real_tables(theta, M):
    """(N, 2(M+1)) stacked [cos(m theta) | sin(m theta)], m = 0..M."""
    m = torch.arange(0, M + 1, dtype=theta.dtype, device=theta.device)
    th = theta[:, None] * m[None, :]
    return torch.cat([torch.cos(th), torch.sin(th)], dim=1)


def _real_weight_full(w, M):
    """tile(w_quadrant wy wz, (2,2,2)) from the signed (M+1, 2M+1, 2M+1)
    weight grid (w is even in ky and kz)."""
    wq = w[:, M:, M:]
    mult = torch.where(torch.arange(M + 1, device=w.device) > 0, 2.0,
                       1.0).to(w.dtype)
    wq = wq * mult[None, :, None] * mult[None, None, :]
    return torch.tile(wq, (2, 2, 2))


def _sf_forward_real(q, tx, ty, tz, M):
    with tracing.span("pme.forward"):
        X = _real_tables(tx, M)
        Y = _real_tables(ty, M)
        Z = _real_tables(tz, M)
        D = Y[:, :, None] * Z[:, None, :]
        T = torch.einsum('nx,nyz->xyz', q[:, None] * X, D)
    return T, X, Y, Z


def _swap_mblocks(B, axis, M):
    """Fold d[cos|sin]/dtheta into the k-tensor: sum_b B * d(table)/dtheta
    == sum_b B' * table with B' = [m B_sin | -m B_cos] along ``axis``."""
    Bc = B.narrow(axis, 0, M + 1)
    Bs = B.narrow(axis, M + 1, M + 1)
    shape = [1] * B.ndim
    shape[axis] = M + 1
    m = torch.arange(0, M + 1, dtype=B.dtype, device=B.device).reshape(shape)
    return torch.cat([m * Bs, -m * Bc], dim=axis)


def _sf_real_backward(q, tx, ty, tz, w, T, M, g):
    """Cotangents (dq, dtx, dty, dtz, dw) of W = sum w |S|^2 in the real
    basis: all four finishing sums share one (N, yz) staging and ONE heavy
    contraction against block-swapped copies of B = dW/dT."""
    with tracing.span("pme.backward"):
        X = _real_tables(tx, M)
        Y = _real_tables(ty, M)
        Z = _real_tables(tz, M)
        B = (2.0 * g) * _real_weight_full(w, M) * T
        G = torch.stack([B,
                         _swap_mblocks(B, 0, M),
                         _swap_mblocks(B, 1, M),
                         _swap_mblocks(B, 2, M)], dim=-1)
        D = Y[:, :, None] * Z[:, None, :]
        V = torch.einsum('nyz,xyza->nxa', D, G)
        H = torch.sum(V * X[:, :, None], dim=1)          # (N, 4)
        dq = H[:, 0]
        dtx = q * H[:, 1]
        dty = q * H[:, 2]
        dtz = q * H[:, 3]
        # w cotangent: per-signed-cell |S|^2 rebuilt from the T blocks
        M1 = M + 1
        Tr1, Ti1 = T[:M1, :M1, :M1], T[M1:, :M1, :M1]
        Tr2, Ti2 = T[:M1, :M1, M1:], T[M1:, :M1, M1:]
        Tr3, Ti3 = T[:M1, M1:, :M1], T[M1:, M1:, :M1]
        Tr4, Ti4 = T[:M1, M1:, M1:], T[M1:, M1:, M1:]

        def s2q(sy, sz):
            sre = Tr1 - (sy * sz) * Tr4 - sz * Ti2 - sy * Ti3
            sim = Ti1 - (sy * sz) * Ti4 + sz * Tr2 + sy * Tr3
            return sre * sre + sim * sim

        def z_row(sy):
            neg = torch.flip(s2q(sy, -1)[:, :, 1:], dims=[2])   # mz = M..1
            return torch.cat([neg, s2q(sy, 1)], dim=2)

        s2 = torch.cat([torch.flip(z_row(-1)[:, 1:, :], dims=[1]), z_row(1)],
                       dim=1)
        dw = g * s2
        return dq, dtx, dty, dtz, dw


class _SFWeightedSumReal(torch.autograd.Function):
    """Real-basis W = sum_k w(k)|S(k)|^2 (same contract as
    :func:`_sf_weighted_sum`; ``w`` is the same signed Hermitian-half grid)
    with the hand backward :func:`_sf_real_backward`. Under
    ``torch.func.vmap`` (the batched step program's remainder, one
    configuration a replica) each configuration is its own evaluation,
    forward and backward (:meth:`vmap`)."""

    @staticmethod
    def forward(q, tx, ty, tz, w, M):
        T, _, _, _ = _sf_forward_real(q, tx, ty, tz, M)
        return torch.sum(_real_weight_full(w, M) * T * T), T

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, tx, ty, tz, w, M = inputs
        ctx.M = M
        ctx.save_for_backward(q, tx, ty, tz, w, output[1])
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, g, _g_T):
        q, tx, ty, tz, w, T = ctx.saved_tensors
        grads = _sf_real_backward(q, tx, ty, tz, w, T, ctx.M, g)
        return (*grads, None)

    @staticmethod
    def vmap(info, in_dims, q, tx, ty, tz, w, M):
        """A batch as its configurations' single evaluations, one after
        another: the contractions' rounding does not depend on the batch
        (a batched matrix product may sum in another order), so a replica
        of a batch follows the trajectory it follows alone."""
        def item(t, dim, b):
            return t if dim is None else t.select(dim, b)

        outs = [_SFWeightedSumReal.apply(
            *(item(t, d, b) for t, d in zip((q, tx, ty, tz, w), in_dims)),
            M) for b in range(info.batch_size)]
        return ((torch.stack([o[0] for o in outs]),
                 torch.stack([o[1] for o in outs])), (0, 0))


def _sf_weighted_sum_real(q, tx, ty, tz, w, M):
    return _SFWeightedSumReal.apply(q, tx, ty, tz, w, M)[0]


def _half_space_kvectors(n_max: Tuple[int, int, int]) -> np.ndarray:
    """Integer k-vectors covering half of reciprocal space (k and -k give
    identical |S|^2; the weight 2 is applied in the energy)."""
    nx, ny, nz = n_max
    ks = []
    for kx in range(0, nx + 1):
        ky_lo = -ny if kx > 0 else 0
        for ky in range(ky_lo, ny + 1):
            kz_lo = -nz if (kx > 0 or ky > 0) else 1
            for kz in range(kz_lo, nz + 1):
                ks.append((kx, ky, kz))
    return np.asarray(ks, dtype=np.float64)


@tensor_dataclass
class EwaldReciprocalTerm:
    """Reciprocal-space + self + exclusion-correction energy term.

    Built by system factories alongside a NonbondedTerm with method
    'pme'/'ewald' (which supplies the erfc direct space).
    ``charge_scale_param`` mirrors the NonbondedTerm hook so that
    alchemical charge scaling affects reciprocal space too. With ``kmax``
    set, the energy goes through the factorized structure factors; without
    it, through the explicit (n_k, N) cos/sin matrix of ``kvecs``.
    """

    charge: torch.Tensor               # (N,)
    kvecs: torch.Tensor                # (n_k, 3) integer reciprocal indices
    exclusion_index: torch.Tensor      # (E, 2) pairs excluded from direct space
    alch_mask: Optional[torch.Tensor] = None   # (N,) 1 = alchemical particle
    alpha: float = static_field(default=3.0)
    force_group: int = static_field(default=0)
    charge_scale_param: Optional[str] = static_field(default=None)
    lambda_name: Optional[str] = static_field(default=None)
    kmax: Optional[int] = static_field(default=None)

    @property
    def global_defaults(self):
        out = {}
        if self.lambda_name is not None:
            out[self.lambda_name] = 1.0
        return out

    def weight_grid(self, box):
        """Hermitian half-cube k-space weight grid (M+1, 2M+1, 2M+1) of the
        factorized path (kmax set); k = 0 has weight 0."""
        M = int(self.kmax)
        lengths = torch.diagonal(box)
        dtype, dev = lengths.dtype, lengths.device
        two_pi = 2.0 * math.pi
        mj = torch.arange(-M, M + 1, dtype=dtype, device=dev)
        mjx = torch.arange(0, M + 1, dtype=dtype, device=dev)
        kx_ax = two_pi * mjx / lengths[0]
        ky_ax = two_pi * mj / lengths[1]
        kz_ax = two_pi * mj / lengths[2]
        k2 = (kx_ax[:, None, None] ** 2 + ky_ax[None, :, None] ** 2
              + kz_ax[None, None, :] ** 2)
        inv_k2 = torch.where(k2 > 0, 1.0 / torch.clamp(k2, min=1e-12), 0.0)
        hermitian = torch.where(mjx > 0, 2.0, 1.0).to(dtype)[:, None, None]
        return (hermitian * torch.exp(-k2 / (4.0 * self.alpha * self.alpha))
                * inv_k2)

    def _reciprocal_factorized(self, q, x, lengths, volume, box):
        """E_rec via factorized structure factors over the Hermitian half
        k-box: per-axis phase tables, one outer product C = Py Pz and one
        matrix product S = (q Px)^T C."""
        M = int(self.kmax)
        two_pi = 2.0 * math.pi
        weight = self.weight_grid(box)
        W = _sf_weighted_sum_real(q, (two_pi / lengths[0]) * x[:, 0],
                                  (two_pi / lengths[1]) * x[:, 1],
                                  (two_pi / lengths[2]) * x[:, 2], weight, M)
        return ONE_4PI_EPS0 * (two_pi / volume) * W

    def effective_charge(self, params=None):
        """Charges after global-parameter scaling (alchemical charges scale
        linearly with lambda in both direct and reciprocal space)."""
        q = self.charge
        if (self.charge_scale_param is not None and params is not None
                and self.charge_scale_param in params):
            q = q * params[self.charge_scale_param]
        if (self.lambda_name is not None and self.alch_mask is not None
                and params is not None and self.lambda_name in params):
            lam = params[self.lambda_name]
            q = q * (1.0 + (lam - 1.0) * self.alch_mask)
        return q

    def self_energy(self, q):
        """O(N) Ewald self-energy (configuration-independent)."""
        return (-ONE_4PI_EPS0 * self.alpha / math.sqrt(math.pi)
                * torch.sum(q * q))

    def exclusion_correction_of_r(self, q, r):
        """Exclusion correction from pair distances ``r`` aligned with the
        rows of ``exclusion_index``: the hook the sweep path uses to share
        one pair loop with the exception add-back."""
        i = self.exclusion_index[:, 0].long()
        j = self.exclusion_index[:, 1].long()
        return -ONE_4PI_EPS0 * torch.sum(
            q[i] * q[j] * torch.special.erf(self.alpha * r) / r)

    def exclusion_energy(self, q, x, box):
        """O(E) exclusion corrections."""
        if self.exclusion_index.shape[0] == 0:
            return torch.zeros((), dtype=x.dtype, device=x.device)
        lengths = torch.diagonal(box)
        i = self.exclusion_index[:, 0].long()
        j = self.exclusion_index[:, 1].long()
        d = x[i] - x[j]
        d = d - lengths * torch.round(d / lengths)
        r = torch.sqrt(torch.clamp(torch.sum(d * d, dim=1), min=1e-12))
        return self.exclusion_correction_of_r(q, r)

    def self_exclusion_energy(self, q, x, box):
        """Self energy + exclusion corrections (the O(N)+O(E) remainder)."""
        return self.self_energy(q) + self.exclusion_energy(q, x, box)

    def energy_without_exclusions(self, x, box, params=None):
        """k-space + self energy only, in float64 (the self energy, about
        -2e6 kJ/mol at 24,000 atoms, summed in float64); the caller supplies
        the exclusion correction (``exclusion_correction_of_r``) from a pair
        loop it already runs."""
        q = self.effective_charge(params)
        lengths = torch.diagonal(box)
        volume = torch.prod(lengths)
        if self.kmax is None:
            raise NotImplementedError(
                "fused exclusion path requires the factorized (kmax) form")
        e_rec = self._reciprocal_factorized(q, x, lengths, volume, box)
        return (e_rec.to(torch.float64)
                + self.self_energy(q.to(torch.float64)))

    def energy(self, x, box, params=None):
        q = self.effective_charge(params)
        lengths = torch.diagonal(box)
        volume = torch.prod(lengths)
        two_pi = 2.0 * math.pi
        if self.kmax is not None:
            e_rec = self._reciprocal_factorized(q, x, lengths, volume, box)
        else:
            # k vectors in physical units (orthorhombic)
            k_phys = two_pi * self.kvecs.to(x.dtype) / lengths[None, :]
            k2 = torch.sum(k_phys * k_phys, dim=1)
            phase = k_phys @ x.T                          # (n_k, N)
            c = torch.cos(phase) @ q
            s = torch.sin(phase) @ q
            s2 = c * c + s * s
            weight = torch.exp(-k2 / (4.0 * self.alpha * self.alpha)) / k2
            e_rec = (ONE_4PI_EPS0 * (two_pi / volume)
                     * 2.0 * torch.sum(weight * s2))
        return e_rec + self.self_exclusion_energy(q, x, box)


def make_ewald_reciprocal_term(charges, box_edge, cutoff, exclusion_index,
                               tol: float = DEFAULT_EWALD_ERROR_TOLERANCE,
                               charge_scale_param=None,
                               device="cuda") -> EwaldReciprocalTerm:
    alpha = ewald_alpha(cutoff, tol)
    n_max = ewald_kmax(alpha, box_edge, tol)
    kvecs = _half_space_kvectors((n_max, n_max, n_max))
    return EwaldReciprocalTerm(
        charge=torch.as_tensor(np.asarray(charges, dtype=np.float32),
                               device=device),
        kvecs=torch.as_tensor(np.asarray(kvecs, dtype=np.float32),
                              device=device),
        exclusion_index=torch.as_tensor(
            np.asarray(exclusion_index, dtype=np.int32), device=device),
        alpha=float(alpha), charge_scale_param=charge_scale_param,
        kmax=n_max)
