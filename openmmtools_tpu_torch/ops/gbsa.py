"""GBSA-OBC implicit solvent as a dense pairwise term (counterpart of
``ops/gbsa.py``).

Hawkins–Cramer–Truhlar descreening with Onufriev–Bashford–Case rescaling
(OBC II by default, OBC I through the constants, HCT with ``hct=True``):

  or_i  = radius_i - offset              (offset = 0.009 nm)
  I_i   = sum_j 0.5 [ 1/L - 1/U + (r - s_j^2/r)(1/U^2 - 1/L^2)/4
                      + ln(L/U)/(2r) ]   (U = r + s_j, L = max(or_i, |r - s_j|),
                                          s_j = screen_j * or_j; zero when
                                          or_i >= U)
  psi   = I_i * or_i
  1/B_i = 1/or_i - tanh(alpha psi - beta psi^2 + gamma psi^3) / radius_i
  E_pol = -0.5 k_e (1/eps_solute - 1/eps_solvent)
          sum_ij q_i q_j / sqrt(r^2 + B_i B_j exp(-r^2/(4 B_i B_j)))
          (i = j included: the Born self energy)
  E_np  = sum_i 28.3919551 (radius_i + 0.14)^2 (radius_i / B_i)^6   [kJ/mol]

The displacements are raw, x_i - x_j: no minimum image and no cutoff, as in
the JAX package, whatever the system's box (the port is held to the JAX
package; see ROADMAP's reference-side findings). The evaluation is dense
(N, N), in the JAX package too; it is plain XLA there, so plain PyTorch is
its port.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from openmmtools_tpu_torch.constants import ONE_4PI_EPS0
from openmmtools_tpu_torch.utils.pytree import static_field, tensor_dataclass

OFFSET = 0.009          # nm dielectric offset
OBC1 = (0.8, 0.0, 2.909125)   # igb=2 constants
OBC2 = (1.0, 0.8, 4.85)       # igb=5 constants
ALPHA, BETA, GAMMA = OBC2
SURFACE_TENSION = 28.3919551  # kJ/mol/nm^2
PROBE = 0.14            # nm solvent probe radius


@tensor_dataclass
class GBSAOBCTerm:
    """OBC generalized Born + ACE nonpolar term.

    Alchemical softening (the factory sets ``lambda_name`` and
    ``alchemical``, a per-atom 0/1 flag a_i): with g_i = lambda a_i +
    (1 - a_i), the descreening by atom j scales by g_j, the pair polar term
    uses g_i q_i g_j q_j, and the Born self term and the surface term scale
    linearly, by g_i.
    """

    charge: torch.Tensor       # (N,)
    radius: torch.Tensor       # (N,) intrinsic Born radii, nm
    scale: torch.Tensor        # (N,) HCT screening factors
    solute_dielectric: float = static_field(default=1.0)
    solvent_dielectric: float = static_field(default=78.5)
    surface_area_energy: bool = static_field(default=True)
    obc_alpha: float = static_field(default=ALPHA)
    obc_beta: float = static_field(default=BETA)
    obc_gamma: float = static_field(default=GAMMA)
    hct: bool = static_field(default=False)
    lambda_name: Optional[str] = static_field(default=None)
    alchemical: Optional[torch.Tensor] = None   # (N,) 1.0 = alchemical atom
    force_group: int = static_field(default=0)

    @property
    def global_defaults(self) -> Dict[str, float]:
        return {} if self.lambda_name is None else {self.lambda_name: 1.0}

    def _g(self, params):
        """Per-particle alchemical scale g_i (None when not alchemical)."""
        if (self.lambda_name is None or params is None
                or self.lambda_name not in params):
            return None
        lam = params[self.lambda_name]
        a = (torch.ones_like(self.charge) if self.alchemical is None
             else self.alchemical)
        return lam * a + (1.0 - a)

    def born_radii(self, x, g=None):
        n = x.shape[0]
        or_i = self.radius - OFFSET
        s_j = self.scale * or_i  # screened radii (per j)
        d = x[:, None, :] - x[None, :, :]
        r2 = torch.sum(d * d, dim=-1)
        off_diag = ~torch.eye(n, dtype=torch.bool, device=x.device)
        # double where: the diagonal's r2 = 0 must not reach the sqrt's
        # gradient
        r = torch.sqrt(torch.where(off_diag, torch.clamp(r2, min=1e-12),
                                   1.0))

        sj = s_j[None, :]
        oi = or_i[:, None]
        u = r + sj
        l = torch.maximum(oi, torch.abs(r - sj))
        # the pairwise descreening integral, active only where the
        # descreening sphere pokes out of atom i's offset radius (oi < u)
        active = off_diag & (oi < u)
        l_safe = torch.where(active, l, 1.0)
        u_safe = torch.where(active, u, 1.0)
        r_safe = torch.where(active, r, 1.0)
        inv_l = 1.0 / l_safe
        inv_u = 1.0 / u_safe
        term = (inv_l - inv_u
                + 0.25 * (r_safe - sj * sj / r_safe)
                * (inv_u * inv_u - inv_l * inv_l)
                + 0.5 * torch.log(l_safe / u_safe) / r_safe)
        # the close-contact correction where the descreening sphere engulfs
        # atom i: 2 (1/or_i - 1/L)
        term = term + torch.where(sj - r_safe - oi > 0.0,
                                  2.0 * (1.0 / oi - inv_l), 0.0)
        pair = torch.where(active, term, 0.0)
        if g is not None:
            pair = pair * g[None, :]
        i_sum = 0.5 * torch.sum(pair, dim=1)

        if self.hct:
            inv_b = 1.0 / or_i - i_sum
            return 1.0 / torch.clamp(inv_b, min=1e-6)
        psi = i_sum * or_i
        tanh_arg = (self.obc_alpha * psi - self.obc_beta * psi ** 2
                    + self.obc_gamma * psi ** 3)
        inv_b = 1.0 / or_i - torch.tanh(tanh_arg) / self.radius
        return 1.0 / torch.clamp(inv_b, min=1e-6)

    def energy(self, x, box, params=None):
        n = x.shape[0]
        g = self._g(params)
        b = self.born_radii(x, g=g)
        q = self.charge
        d = x[:, None, :] - x[None, :, :]
        r2 = torch.sum(d * d, dim=-1)
        bb = b[:, None] * b[None, :]
        f_gb = torch.sqrt(r2 + bb * torch.exp(-r2 / (4.0 * bb)))
        prefactor = -0.5 * ONE_4PI_EPS0 * (
            1.0 / self.solute_dielectric - 1.0 / self.solvent_dielectric)
        qg = q if g is None else q * g
        qq = qg[:, None] * qg[None, :]
        if g is not None:
            # the self (diagonal) polar term scales linearly in g
            diag = torch.eye(n, dtype=torch.bool, device=x.device)
            qq = torch.where(diag, (g * q * q)[:, None].expand(n, n), qq)
        e = prefactor * torch.sum(qq / f_gb)
        if self.surface_area_energy:
            e_np = SURFACE_TENSION * (self.radius + PROBE) ** 2 \
                * (self.radius / b) ** 6
            if g is not None:
                e_np = e_np * g
            e = e + torch.sum(e_np)
        return e
