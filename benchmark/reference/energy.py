"""The plain reference: the potential energy and forces of a periodic,
cubic, Ewald-summed system, written from the published definitions.

It imports torch and numpy alone, and takes its parameters from a
:class:`~benchmark.reference.forcefield.Spec` that the benchmark built from
its own topology. Every term is computed directly:

* direct space: pairs closer than the cutoff, not excluded,
  ``k_e q_i q_j erfc(alpha r) / r`` and Lennard-Jones
  ``4 eps ((sigma/r)^12 - (sigma/r)^6)`` with Lorentz-Berthelot combining,
  times OpenMM's switch ``1 - 10 t^3 + 15 t^4 - 6 t^5`` over the switching
  width where the configuration has one;
* alchemical pairs (one atom in the alchemical region): Beutler's softcore
  ``lam_s 4 eps x (x - 1)``, ``x = 1 / (alpha_sc (1 - lam_s) + (r/sigma)^6)``,
  and the Coulomb term times ``lam_e`` (openmmtools' direct-space PME
  treatment: reciprocal space keeps the full charges);
* exceptions (scaled 1-4 pairs): plain Coulomb and Lennard-Jones with their
  own parameters, no cutoff;
* the Ewald sum: ``alpha = sqrt(-ln(2 tol)) / r_c``, every reciprocal vector
  with ``|n_x|, |n_y|, |n_z| <= ceil(alpha L sqrt(-ln(2 tol)) / pi)``, the
  self term, and ``-k_e q_i q_j erf(alpha r) / r`` for every excluded or
  excepted pair;
* the isotropic dispersion tail ``(2 pi N^2 / V) <4 eps (sigma^12 / (9
  r_c^9) - sigma^6 / (3 r_c^3))>`` over the N^2 ordered atom pairs, each
  alchemical pair weighted by ``lam_s``.

Forces are minus the gradient, by autograd, term by term and block by
block, so that a 24,000-atom system fits in a few GiB. ``dtype`` sets the
precision of every operation; ``tf32`` rounds the operands of the k-space
matrix products to TF32 (10 mantissa bits), as a card does with TF32 on:
the benchmark's control.
"""
from __future__ import annotations

import math

import numpy as np
import torch

ONE_4PI_EPS0 = 138.93545764438198   # kJ mol^-1 nm e^-2 (CODATA 2018)
K_BOLTZMANN = 0.00831446261815324   # kJ mol^-1 K^-1


def tf32_round(x):
    """``x`` (float32) rounded to the nearest TF32 value (10 explicit
    mantissa bits, ties away from zero); the gradient passes straight
    through."""
    bits = x.detach().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return x + (bits.view(torch.float32) - x).detach()


def ewald_alpha(cutoff, tol):
    return math.sqrt(-math.log(2.0 * tol)) / cutoff


def ewald_nmax(alpha, box_edge, tol):
    return max(1, int(math.ceil(alpha * box_edge
                                * math.sqrt(-math.log(2.0 * tol)) / math.pi)))


def half_space_vectors(n_max):
    """Integer reciprocal vectors of one half space (k and -k give the same
    |S|^2), within the cube |n_i| <= n_max, k = 0 left out."""
    r = np.arange(-n_max, n_max + 1)
    n = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    keep = ((n[:, 0] > 0) | ((n[:, 0] == 0) & (n[:, 1] > 0))
            | ((n[:, 0] == 0) & (n[:, 1] == 0) & (n[:, 2] > 0)))
    return n[keep]


def minimum_image(d, box_edge):
    return d - box_edge * torch.round(d / box_edge)


def switch(r, cutoff, width):
    if width is None:
        return torch.ones_like(r)
    t = torch.clamp((r - (cutoff - width)) / width, min=0.0, max=1.0)
    return 1.0 - t ** 3 * (10.0 - 15.0 * t + 6.0 * t * t)


def lj(r2, sigma, epsilon):
    """Lennard-Jones; a pair with epsilon 0 gives 0 whatever its sigma."""
    sigma = torch.where(epsilon > 0, sigma, 1.0)
    s6 = (sigma * sigma / r2) ** 3
    return 4.0 * epsilon * s6 * (s6 - 1.0)


def softcore_lj(r2, sigma, epsilon, lam, alpha_sc):
    sigma = torch.where(epsilon > 0, sigma, 1.0)
    x = 1.0 / (alpha_sc * (1.0 - lam) + (r2 / (sigma * sigma)) ** 3)
    return lam * 4.0 * epsilon * x * (x - 1.0)


class Reference:
    """Energies and forces of one :class:`Spec` on ``device`` in ``dtype``
    (float64 for the reference, float32 with ``tf32`` for the control)."""

    def __init__(self, spec, device, dtype=torch.float64, tf32=False,
                 pair_block=256, k_block=512):
        self.spec = spec
        self.device = torch.device(device)
        self.dtype = dtype
        self.tf32 = tf32
        self.pair_block = pair_block
        self.k_block = k_block
        t = self._t
        self.q = t(spec.charge)
        self.sigma = t(spec.sigma)
        self.eps = t(spec.epsilon)
        self.alch = torch.as_tensor(spec.alchemical, device=self.device)
        self.exc = torch.as_tensor(spec.exception_pairs, dtype=torch.long,
                                   device=self.device)
        self.exc_qq = t(spec.exception_qq)
        self.exc_sig = t(spec.exception_sigma)
        self.exc_eps = t(spec.exception_epsilon)
        self.alpha = ewald_alpha(spec.cutoff, spec.ewald_tolerance)
        self.n_max = ewald_nmax(self.alpha, spec.box_edge,
                                spec.ewald_tolerance)
        self.kvec = t(half_space_vectors(self.n_max))
        self.excluded = self._excluded_keys()

    def _t(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def _excluded_keys(self):
        """Sorted keys i * N + j (i < j) of every exception pair."""
        n = self.spec.n_atoms
        i = torch.minimum(self.exc[:, 0], self.exc[:, 1])
        j = torch.maximum(self.exc[:, 0], self.exc[:, 1])
        return torch.sort(i * n + j).values

    # -- pair lists ------------------------------------------------------
    def pairs_within(self, x, box_edge, cutoff):
        """(P, 2) index pairs i < j closer than ``cutoff`` (minimum image),
        exceptions left out, found by brute force in blocks of rows."""
        n = x.shape[0]
        out = []
        rc2 = cutoff * cutoff
        with torch.no_grad():
            for a in range(0, n, self.pair_block):
                b = min(n, a + self.pair_block)
                d = minimum_image(x[a:b, None, :] - x[None, :, :], box_edge)
                r2 = torch.sum(d * d, dim=-1)
                rows = torch.arange(a, b, device=x.device)[:, None]
                cols = torch.arange(n, device=x.device)[None, :]
                ii, jj = torch.nonzero((r2 < rc2) & (cols > rows),
                                       as_tuple=True)
                out.append(torch.stack([ii + a, jj], dim=1))
        pairs = torch.cat(out)
        keys = pairs[:, 0] * n + pairs[:, 1]
        if self.excluded.numel():
            pos = torch.searchsorted(self.excluded, keys)
            pos = torch.clamp(pos, max=self.excluded.numel() - 1)
            pairs = pairs[self.excluded[pos] != keys]
        return pairs

    # -- the terms -------------------------------------------------------
    def _direct(self, x, pairs, box_edge, lam_e, lam_s):
        spec = self.spec
        i, j = pairs[:, 0], pairs[:, 1]
        d = minimum_image(x[i] - x[j], box_edge)
        r2 = torch.sum(d * d, dim=-1)
        r = torch.sqrt(r2)
        sig = 0.5 * (self.sigma[i] + self.sigma[j])
        eps = torch.sqrt(self.eps[i] * self.eps[j])
        a_i, a_j = self.alch[i], self.alch[j]
        na = a_i ^ a_j                     # one atom alchemical
        aa = a_i & a_j                     # both (one region)
        sw = switch(r, spec.cutoff, spec.switch_width)
        e_lj = torch.where(na, softcore_lj(r2, sig, eps, lam_s,
                                           spec.softcore_alpha),
                           lj(r2, sig, eps)) * sw
        scale_e = torch.where(na | aa, torch.full_like(r, lam_e),
                              torch.ones_like(r))
        e_c = (ONE_4PI_EPS0 * scale_e * self.q[i] * self.q[j]
               * torch.special.erfc(self.alpha * r) / r)
        return torch.sum(e_lj + e_c)

    def _exceptions(self, x, box_edge, lam_e):
        if self.exc.shape[0] == 0:
            return x.new_zeros(())
        i, j = self.exc[:, 0], self.exc[:, 1]
        d = minimum_image(x[i] - x[j], box_edge)
        r2 = torch.sum(d * d, dim=-1)
        r = torch.sqrt(r2)
        alch = self.alch[i] | self.alch[j]
        qq = torch.where(alch, lam_e * self.exc_qq, self.exc_qq)
        # (an exception inside the region keeps its Lennard-Jones: the
        # region is decoupled in sterics, annihilated in electrostatics)
        e = ONE_4PI_EPS0 * qq / r + lj(r2, self.exc_sig, self.exc_eps)
        # the Ewald sum counts every excluded pair at its full charges
        e = e - (ONE_4PI_EPS0 * self.q[i] * self.q[j]
                 * torch.special.erf(self.alpha * r) / r)
        return torch.sum(e)

    def _mm(self, a, b):
        if self.tf32:
            a, b = tf32_round(a), tf32_round(b)
        return a @ b

    def _reciprocal(self, x, box_edge, k_rows):
        """The half-space k-vectors ``k_rows``' part of the reciprocal sum."""
        k = (2.0 * math.pi / box_edge) * k_rows
        k2 = torch.sum(k * k, dim=1)
        w = torch.exp(-k2 / (4.0 * self.alpha * self.alpha)) / k2
        phase = self._mm(k, x.T)
        c = self._mm(torch.cos(phase), self.q[:, None])[:, 0]
        s = self._mm(torch.sin(phase), self.q[:, None])[:, 0]
        volume = box_edge ** 3
        return ONE_4PI_EPS0 * (4.0 * math.pi / volume) * torch.sum(
            w * (c * c + s * s))

    def constant_terms(self, box_edge, lam_s):
        """The self energy and the dispersion tail (no force)."""
        spec = self.spec
        e_self = (-ONE_4PI_EPS0 * self.alpha / math.sqrt(math.pi)
                  * torch.sum(self.q * self.q))
        if not spec.dispersion_correction:
            return e_self
        # the N^2 ordered pairs, grouped by (sigma, epsilon, alchemical)
        key = np.stack([spec.sigma, spec.epsilon,
                        np.asarray(spec.alchemical, float)], 1)
        classes, counts = np.unique(key, axis=0, return_counts=True)
        sig = self._t(classes[:, 0])
        eps = self._t(classes[:, 1])
        alch = torch.as_tensor(classes[:, 2] > 0, device=self.device)
        cnt = self._t(counts.astype(np.float64))
        s = 0.5 * (sig[:, None] + sig[None, :])
        e = torch.sqrt(eps[:, None] * eps[None, :])
        rc = spec.cutoff
        tail = 4.0 * e * (s ** 12 / (9.0 * rc ** 9) - s ** 6 / (3.0 * rc ** 3))
        weight = torch.where(alch[:, None] ^ alch[None, :],
                             torch.full_like(tail, lam_s),
                             torch.ones_like(tail))
        n = spec.n_atoms
        mean = torch.sum(cnt[:, None] * cnt[None, :] * weight * tail) / (n * n)
        return e_self + 2.0 * math.pi * n * n / box_edge ** 3 * mean

    # -- public ----------------------------------------------------------
    def energy_forces(self, positions, box_edge, lam_e=1.0, lam_s=1.0,
                      forces=True, pairs=None):
        """(U, F) at ``positions`` (N, 3) in kJ/mol and kJ/mol/nm, on the
        host in float64; F is None without ``forces``."""
        x0 = torch.as_tensor(np.asarray(positions), dtype=self.dtype,
                             device=self.device)
        box_edge = float(box_edge)
        if pairs is None:
            pairs = self.pairs_within(x0, box_edge, self.spec.cutoff)
        x = x0.clone().requires_grad_(forces)
        grad = torch.zeros_like(x0)
        total = torch.zeros((), dtype=torch.float64, device=self.device)

        def add(e):
            nonlocal total, grad
            total = total + e.detach().to(torch.float64)
            if forces and e.requires_grad:
                grad += torch.autograd.grad(e, x)[0]

        chunk = 1 << 20
        for a in range(0, pairs.shape[0], chunk):
            add(self._direct(x, pairs[a:a + chunk], box_edge, lam_e, lam_s))
        add(self._exceptions(x, box_edge, lam_e))
        for a in range(0, self.kvec.shape[0], self.k_block):
            add(self._reciprocal(x, box_edge, self.kvec[a:a + self.k_block]))
        add(self.constant_terms(box_edge, lam_s))
        u = float(total)
        f = (-grad).to(torch.float64).cpu().numpy() if forces else None
        return u, f

    def energies_over(self, positions, box_edge, lambdas, pairs=None):
        """U (kJ/mol) at ``positions`` under each (lam_e, lam_s) of
        ``lambdas``: the terms that do not depend on lambda once, the
        alchemical pairs, the exceptions and the tails at each."""
        x = torch.as_tensor(np.asarray(positions), dtype=self.dtype,
                            device=self.device)
        box_edge = float(box_edge)
        with torch.no_grad():
            if pairs is None:
                pairs = self.pairs_within(x, box_edge, self.spec.cutoff)
            alch = self.alch[pairs[:, 0]] | self.alch[pairs[:, 1]]
            fixed = torch.zeros((), dtype=torch.float64,
                                device=self.device)
            plain = pairs[~alch]
            chunk = 1 << 20
            for a in range(0, plain.shape[0], chunk):
                fixed = fixed + self._direct(x, plain[a:a + chunk], box_edge,
                                             1.0, 1.0).to(torch.float64)
            for a in range(0, self.kvec.shape[0], self.k_block):
                fixed = fixed + self._reciprocal(
                    x, box_edge, self.kvec[a:a + self.k_block]).to(
                        torch.float64)
            out = []
            for lam_e, lam_s in lambdas:
                e = (self._direct(x, pairs[alch], box_edge, lam_e, lam_s)
                     + self._exceptions(x, box_edge, lam_e)
                     + self.constant_terms(box_edge, lam_s))
                out.append(float(fixed + e.to(torch.float64)))
        return out
