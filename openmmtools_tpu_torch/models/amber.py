"""Amber prmtop/inpcrd readers -> System (counterpart of
``models/amber.py``).

The reference builds its molecular test systems (alanine dipeptide, host-
guest, DHFR, ...) by loading Amber parameter files through openmm.app. This
module parses the public, documented Amber prmtop format directly into a
:class:`openmmtools_tpu_torch.system.System`, with the JAX package's
conversions, in the same order and in float64 numpy, cast to float32 at the
end, so that both packages hold the same float32 parameters:

* CHARGE is stored as q * 18.2223 (kcal^1/2 Å^1/2): divided out.
* Bond/angle force constants use the Amber convention U = K (r - r0)^2
  (no 1/2): converted to the harmonic convention k = 2 K, with kcal/Å ->
  kJ/nm.
* LENNARD_JONES_ACOEF/BCOEF diagonal entries give per-type sigma/epsilon
  (A = 4 eps sig^12, B = 4 eps sig^6); Lorentz-Berthelot combination is
  then used (exact for the standard Amber force fields).
* 1-2 and 1-3 pairs are fully excluded; 1-4 pairs become exceptions with
  chargeprod / SCEE and epsilon / SCNB (defaults 1.2 / 2.0). The
  exclusions come first, sorted, then the 1-4 pairs, sorted; the Ewald
  reciprocal term gets the same list, so the sweep path fuses its
  exclusion correction with the exception add-back.
* ``constraints='h-bonds'`` converts hydrogen bonds to distance
  constraints.

:func:`parse_prmtop` reads a file with the native parser,
``native/prmtop_parser.cpp`` (the JAX package's C ABI, in a copy of the
port's own), built at its first use by the host C++ compiler into
``build/kernels/`` (``ops/_build.host_library``) and loaded with ctypes; a
failed build or load raises with the compiler's stderr, and a file cut
short or with a section shorter than ``POINTERS`` says raises.
:func:`parse_prmtop_python`, the pure-Python fixed-width parser, stays as
its oracle. Positions come from an inpcrd (:func:`parse_inpcrd`) or a PDB
(:func:`parse_pdb_positions`).
:class:`AmberTopology` carries atom and residue names for mdtraj-style
selections (``select("protein and name CA")``).

Data: the reference's files, under ``$OPENMMTOOLS_TPU_DATA`` (the JAX
package's variable), by default ``data/`` at the root of the checkout.
"""
from __future__ import annotations

import ctypes
import functools
import os
import re
from typing import Dict, List, Optional

import numpy as np
import torch

from openmmtools_tpu_torch.ops.gbsa import OBC1, OBC2, GBSAOBCTerm
from openmmtools_tpu_torch.ops.pme import ewald_alpha, make_ewald_reciprocal_term
from openmmtools_tpu_torch.system import (
    Constraints,
    HarmonicAngleTerm,
    HarmonicBondTerm,
    NonbondedTerm,
    PeriodicTorsionTerm,
    System,
    no_constraints,
)

KCAL = 4.184
A2NM = 0.1
AMBER_CHARGE = 18.2223

# the reference's data files (read-only); the systems read this name when
# they are built, so a caller may set it (tests patch it)
DEFAULT_DATA_DIR = os.environ.get(
    "OPENMMTOOLS_TPU_DATA",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "data"))


class PrmtopError(ValueError):
    """A prmtop that cannot be read whole: cut short, a token that does not
    parse, or a section missing or shorter than ``POINTERS`` says."""


@functools.lru_cache(maxsize=None)
def _native_parser():
    """The native parser's library, built at first use and loaded, with
    its entry points' types declared. Raises where it cannot be built."""
    from openmmtools_tpu_torch.ops import _build

    lib = ctypes.CDLL(str(_build.host_library("prmtop_parser")))
    P, S = ctypes.c_void_p, ctypes.c_char_p
    for name, restype, argtypes in (
            ("prmtop_open", P, [S]),
            ("prmtop_close", None, [P]),
            ("prmtop_status", ctypes.c_int, [P]),
            ("prmtop_section_kind", ctypes.c_int, [P, S]),
            ("prmtop_section_len", ctypes.c_longlong, [P, S]),
            ("prmtop_string_width", ctypes.c_int, [P, S]),
            ("prmtop_n_sections", ctypes.c_longlong, [P]),
            ("prmtop_section_name", None, [P, ctypes.c_longlong, S]),
            ("prmtop_copy_longs", None, [P, S, P]),
            ("prmtop_copy_doubles", None, [P, S, P]),
            ("prmtop_copy_strings", None, [P, S, P])):
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


# the sections whose lengths POINTERS fixes: (flag, length of the pointers
# p); NATOM p[0], NTYPES p[1], NBONH p[2], NTHETH p[4], NPHIH p[6], NRES
# p[11], NBONA p[12], NTHETA p[13], NPHIA p[14], NUMBND p[15], NUMANG
# p[16], NPTRA p[17]
_SECTION_LENGTHS = (
    ("CHARGE", lambda p: p[0]),
    ("MASS", lambda p: p[0]),
    ("ATOM_TYPE_INDEX", lambda p: p[0]),
    ("NONBONDED_PARM_INDEX", lambda p: p[1] * p[1]),
    ("RESIDUE_POINTER", lambda p: p[11]),
    ("BOND_FORCE_CONSTANT", lambda p: p[15]),
    ("BOND_EQUIL_VALUE", lambda p: p[15]),
    ("ANGLE_FORCE_CONSTANT", lambda p: p[16]),
    ("ANGLE_EQUIL_VALUE", lambda p: p[16]),
    ("DIHEDRAL_FORCE_CONSTANT", lambda p: p[17]),
    ("DIHEDRAL_PERIODICITY", lambda p: p[17]),
    ("DIHEDRAL_PHASE", lambda p: p[17]),
    ("LENNARD_JONES_ACOEF", lambda p: p[1] * (p[1] + 1) // 2),
    ("LENNARD_JONES_BCOEF", lambda p: p[1] * (p[1] + 1) // 2),
    ("BONDS_INC_HYDROGEN", lambda p: 3 * p[2]),
    ("BONDS_WITHOUT_HYDROGEN", lambda p: 3 * p[12]),
    ("ANGLES_INC_HYDROGEN", lambda p: 4 * p[4]),
    ("ANGLES_WITHOUT_HYDROGEN", lambda p: 4 * p[13]),
    ("DIHEDRALS_INC_HYDROGEN", lambda p: 5 * p[6]),
    ("DIHEDRALS_WITHOUT_HYDROGEN", lambda p: 5 * p[14]),
)
# sections checked where present: NATOM, NRES, and the box's angle and
# three edges where IFBOX (p[27]) is set, whose BOX_DIMENSIONS is required
_OPTIONAL_LENGTHS = (
    ("ATOM_NAME", lambda p: p[0]),
    ("AMBER_ATOM_TYPE", lambda p: p[0]),
    ("RADII", lambda p: p[0]),
    ("SCREEN", lambda p: p[0]),
    ("RESIDUE_LABEL", lambda p: p[11]),
    ("BOX_DIMENSIONS", lambda p: 4),
)


def _check_sections(data: Dict[str, np.ndarray], path: str) -> None:
    """Raise :class:`PrmtopError` unless every section the loader reads is
    there at the length ``POINTERS`` gives it."""
    p = data.get("POINTERS")
    if p is None or len(p) < 18:
        raise PrmtopError(f"{path}: no POINTERS section of 18 or more "
                          "entries")
    p = [int(v) for v in p]
    required = [flag for flag, _ in _SECTION_LENGTHS]
    if len(p) > 27 and p[27] > 0:
        required.append("BOX_DIMENSIONS")
    for flag, length in _SECTION_LENGTHS + _OPTIONAL_LENGTHS:
        if flag not in data and flag not in required:
            continue
        if flag not in data or len(data[flag]) != length(p):
            have = "missing" if flag not in data else len(data[flag])
            raise PrmtopError(
                f"{path}: section {flag} has {have} entries where POINTERS "
                f"gives {length(p)}: the file is cut short or malformed")


def parse_prmtop(path: str) -> Dict[str, np.ndarray]:
    """Parse a prmtop file into {FLAG: array} (raw, unconverted), with the
    native parser: strings for ``a`` formats, int64 for ``I``, float64
    otherwise; blank string fields are dropped; the sections in the order
    of the file. The same dict as :func:`parse_prmtop_python`. Raises
    :class:`PrmtopError` on a file cut short or malformed, and
    ``KernelBuildError`` where the parser cannot be built."""
    lib = _native_parser()
    h = lib.prmtop_open(os.fsencode(path))
    if not h:
        raise OSError(f"cannot open {path}")
    try:
        status = lib.prmtop_status(h)
        if status:
            raise PrmtopError(
                f"{path}: " + ("a numeric field does not parse" if status == 1
                               else "the file is cut short"))
        out: Dict[str, np.ndarray] = {}
        buf = ctypes.create_string_buffer(128)
        for i in range(lib.prmtop_n_sections(h)):
            lib.prmtop_section_name(h, i, buf)
            flag = buf.value
            kind = lib.prmtop_section_kind(h, flag)
            n = lib.prmtop_section_len(h, flag)
            if kind == 0:
                arr = np.empty(n, dtype=np.int64)
                lib.prmtop_copy_longs(h, flag, arr.ctypes.data)
            elif kind == 1:
                arr = np.empty(n, dtype=np.float64)
                lib.prmtop_copy_doubles(h, flag, arr.ctypes.data)
            elif kind == 2:
                w = lib.prmtop_string_width(h, flag)
                raw = ctypes.create_string_buffer(int(n * w))
                lib.prmtop_copy_strings(h, flag, raw)
                # the fields stripped and the blank ones dropped, as one
                # array operation; the dtype as wide as the longest field,
                # as np.asarray of the strings gives
                fields = np.char.strip(np.frombuffer(raw.raw, dtype=f"S{w}"))
                fields = fields[fields != b""]
                arr = np.asarray([])
                if fields.size:
                    width = int(np.char.str_len(fields).max())
                    arr = fields.astype(f"U{width}")
            else:
                continue
            out[flag.decode()] = arr
    finally:
        lib.prmtop_close(h)
    _check_sections(out, path)
    return out


def parse_prmtop_python(path: str) -> Dict[str, np.ndarray]:
    """:func:`parse_prmtop` in pure Python, the fixed-width fields of each
    section read in order: the native parser's oracle. It checks nothing
    of the file's completeness."""
    sections: Dict[str, List[str]] = {}
    flag = None
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith("%FLAG"):
                flag = line.split()[1]
                sections[flag] = []
            elif line.startswith("%FORMAT"):
                m = re.search(r"\((\d+)([aIEFed])([\d.]+)", line)
                if m and flag is not None:
                    sections[flag + "__fmt"] = [m.group(2).lower(),
                                                m.group(3).split(".")[0]]
            elif line.startswith("%"):
                continue
            elif flag is not None:
                sections[flag].append(line)

    out: Dict[str, np.ndarray] = {}
    for flag, lines in sections.items():
        if flag.endswith("__fmt"):
            continue
        kind, width = sections.get(flag + "__fmt", ["e", "16"])
        width = int(width)
        raw = "".join(lines)
        fields = [raw[i:i + width] for i in range(0, len(raw), width)]
        fields = [f for f in fields if f.strip()]
        if kind == "a":
            out[flag] = np.asarray([f.strip() for f in fields])
        elif kind == "i":
            out[flag] = np.asarray([int(f) for f in fields], dtype=np.int64)
        else:
            out[flag] = np.asarray([float(f) for f in fields])
    return out


def parse_pdb_positions(path: str) -> np.ndarray:
    """Read coordinates (Å -> nm) from an ASCII PDB (ATOM/HETATM records)."""
    coords = []
    with open(path) as fh:
        for line in fh:
            if line.startswith(("ATOM", "HETATM")):
                coords.append((float(line[30:38]), float(line[38:46]),
                               float(line[46:54])))
    return np.asarray(coords) * A2NM


def parse_inpcrd(path: str, return_box: bool = False):
    """Parse an Amber .crd/.inpcrd restart: positions in Å -> nm. With
    ``return_box=True`` also returns the (3,) box lengths in nm (or None)
    read from the trailing box record."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    natoms = int(lines[1].split()[0])
    values: List[float] = []
    for line in lines[2:]:
        for i in range(0, len(line), 12):
            field = line[i:i + 12].strip()
            if field:
                values.append(float(field))
    coords = np.asarray(values[: natoms * 3]).reshape(natoms, 3) * A2NM
    if not return_box:
        return coords
    # the trailing record: 3 lengths (and optionally 3 angles), present
    # only when values follow the coordinates (and velocities)
    box = None
    extra = values[natoms * 3:]
    if len(extra) >= 3:
        cand = extra[-6:] if len(extra) >= 6 else extra[-3:]
        box = np.asarray(cand[:3]) * A2NM
    return coords, box


def create_system_from_prmtop(prmtop_path: str,
                              constraints: Optional[str] = "h-bonds",
                              implicit_solvent: bool = False,
                              gb_model: str = "OBC2",
                              nonbonded_method: str = "no_cutoff",
                              cutoff: float = 0.9,
                              switch_width: Optional[float] = None,
                              ewald_error_tolerance: float = 5e-4,
                              device="cuda") -> System:
    """Build a System from a prmtop: vacuum or implicit solvent (``gb_model``
    'HCT', 'OBC1' or 'OBC2'), or periodic with reaction-field or Ewald
    electrostatics (``nonbonded_method`` in {'no_cutoff',
    'cutoff_periodic', 'pme', 'ewald'}; periodic systems read
    BOX_DIMENSIONS, and the reciprocal term takes the largest edge: a cubic
    box is assumed). ``constraints`` None, 'h-bonds' or 'all-bonds'. The
    tensors go to ``device``: the card unless the caller asks for the
    CPU."""
    return system_from_prmtop_data(
        parse_prmtop(prmtop_path), constraints=constraints,
        implicit_solvent=implicit_solvent, gb_model=gb_model,
        nonbonded_method=nonbonded_method, cutoff=cutoff,
        switch_width=switch_width,
        ewald_error_tolerance=ewald_error_tolerance, device=device)


def system_from_prmtop_data(data: Dict[str, np.ndarray],
                            constraints: Optional[str] = "h-bonds",
                            implicit_solvent: bool = False,
                            gb_model: str = "OBC2",
                            nonbonded_method: str = "no_cutoff",
                            cutoff: float = 0.9,
                            switch_width: Optional[float] = None,
                            ewald_error_tolerance: float = 5e-4,
                            device="cuda") -> System:
    """:func:`create_system_from_prmtop` of a prmtop already parsed."""
    ptr = data["POINTERS"]
    natom = int(ptr[0])
    ntypes = int(ptr[1])

    masses = data["MASS"][:natom]
    charges = data["CHARGE"][:natom] / AMBER_CHARGE
    type_idx = data["ATOM_TYPE_INDEX"][:natom].astype(np.int64) - 1
    nb_parm = data["NONBONDED_PARM_INDEX"].astype(np.int64)
    acoef = data["LENNARD_JONES_ACOEF"]
    bcoef = data["LENNARD_JONES_BCOEF"]

    # per-type sigma/epsilon from the diagonal of the type-pair tables
    sig_t = np.zeros(ntypes)
    eps_t = np.zeros(ntypes)
    for t in range(ntypes):
        j = nb_parm[ntypes * t + t] - 1
        if j < 0:
            continue
        a, b = acoef[j], bcoef[j]
        if b > 0 and a > 0:
            sig_t[t] = (a / b) ** (1.0 / 6.0) * A2NM
            eps_t[t] = b * b / (4.0 * a) * KCAL
        else:
            sig_t[t] = 0.1  # dummy sigma for zero-LJ types
            eps_t[t] = 0.0
    sigmas = sig_t[type_idx]
    epsilons = eps_t[type_idx]

    # bonds ---------------------------------------------------------------
    bond_k = data["BOND_FORCE_CONSTANT"] * 2.0 * KCAL / (A2NM * A2NM)
    bond_r0 = data["BOND_EQUIL_VALUE"] * A2NM

    def rows(flag, width):
        raw = data.get(flag, np.zeros(0, dtype=np.int64)).astype(np.int64)
        return raw.reshape(-1, width)

    def decode_bonds(flag):
        raw = rows(flag, 3)
        return raw[:, 0] // 3, raw[:, 1] // 3, raw[:, 2] - 1

    bi_h, bj_h, bt_h = decode_bonds("BONDS_INC_HYDROGEN")
    bi, bj, bt = decode_bonds("BONDS_WITHOUT_HYDROGEN")

    constrain_h = constraints in ("h-bonds", "all-bonds")
    constrain_all = constraints == "all-bonds"
    c_idx, c_dist = [], []
    keep_i, keep_j, keep_t = [], [], []
    for (ii, jj, tt), constrained in (((bi_h, bj_h, bt_h), constrain_h),
                                      ((bi, bj, bt), constrain_all)):
        for i_, j_, t_ in zip(ii, jj, tt):
            if constrained:
                c_idx.append((i_, j_))
                c_dist.append(bond_r0[t_])
            else:
                keep_i.append(i_)
                keep_j.append(j_)
                keep_t.append(t_)
    bond_index = (np.stack([keep_i, keep_j], axis=1) if keep_i
                  else np.zeros((0, 2), dtype=np.int64))

    def tensor(x, dtype=np.float32):
        return torch.as_tensor(np.asarray(x, dtype=dtype), device=device)

    bond_terms = HarmonicBondTerm(
        index=tensor(bond_index, np.int32),
        length=tensor(bond_r0[keep_t] if keep_t else np.zeros(0)),
        k=tensor(bond_k[keep_t] if keep_t else np.zeros(0)))
    if c_idx:
        constraints_obj = Constraints(index=tensor(c_idx, np.int32),
                                      distance=tensor(c_dist))
    else:
        constraints_obj = no_constraints(device)

    # angles --------------------------------------------------------------
    ang_k = data["ANGLE_FORCE_CONSTANT"] * 2.0 * KCAL
    ang_t0 = data["ANGLE_EQUIL_VALUE"]
    ang = np.concatenate([rows("ANGLES_INC_HYDROGEN", 4),
                          rows("ANGLES_WITHOUT_HYDROGEN", 4)], axis=0)
    a_i, a_j, a_k = ang[:, 0] // 3, ang[:, 1] // 3, ang[:, 2] // 3
    a_t = ang[:, 3] - 1
    angle_terms = HarmonicAngleTerm(
        index=tensor(np.stack([a_i, a_j, a_k], axis=1), np.int32),
        angle=tensor(ang_t0[a_t]), k=tensor(ang_k[a_t]))

    # dihedrals: a negative third index marks a 1-4 pair counted by another
    # term, a negative fourth an improper ----------------------------------
    dih_k = data["DIHEDRAL_FORCE_CONSTANT"] * KCAL
    dih_per = data["DIHEDRAL_PERIODICITY"]
    dih_phase = data["DIHEDRAL_PHASE"]
    scee = data.get("SCEE_SCALE_FACTOR")
    scnb = data.get("SCNB_SCALE_FACTOR")
    d_all = (np.concatenate([rows("DIHEDRALS_INC_HYDROGEN", 5),
                             rows("DIHEDRALS_WITHOUT_HYDROGEN", 5)], axis=0)
             if natom else np.zeros((0, 5), np.int64))
    d_i = np.abs(d_all[:, 0]) // 3
    d_j = np.abs(d_all[:, 1]) // 3
    d_k_signed = d_all[:, 2]
    d_l_signed = d_all[:, 3]
    d_k = np.abs(d_k_signed) // 3
    d_l = np.abs(d_l_signed) // 3
    d_t = d_all[:, 4] - 1
    torsion_terms = PeriodicTorsionTerm(
        index=tensor(np.stack([d_i, d_j, d_k, d_l], axis=1), np.int32),
        periodicity=tensor(np.abs(dih_per[d_t])),
        phase=tensor(dih_phase[d_t]),
        k=tensor(dih_k[d_t]))

    # exclusions (1-2 over every bond, constrained or not, and 1-3) and
    # the scaled 1-4 pairs --------------------------------------------------
    excl = set()
    for i_, j_ in zip(np.concatenate([bi_h, bi]), np.concatenate([bj_h, bj])):
        excl.add((min(i_, j_), max(i_, j_)))
    for i_, k_ in zip(a_i, a_k):
        excl.add((min(i_, k_), max(i_, k_)))
    pair14 = {}
    for r in range(d_all.shape[0]):
        if d_k_signed[r] < 0 or d_l_signed[r] < 0:
            continue
        i_, l_ = int(d_i[r]), int(d_l[r])
        key = (min(i_, l_), max(i_, l_))
        if key in excl or key in pair14:
            continue
        t = int(d_t[r])
        scee_f = float(scee[t]) if scee is not None and scee[t] > 0 else 1.2
        scnb_f = float(scnb[t]) if scnb is not None and scnb[t] > 0 else 2.0
        pair14[key] = (scee_f, scnb_f)

    exc_index, exc_qq, exc_sig, exc_eps = [], [], [], []
    for (i_, j_) in sorted(excl):
        exc_index.append((i_, j_))
        exc_qq.append(0.0)
        exc_sig.append(0.1)
        exc_eps.append(0.0)
    for (i_, j_), (scee_f, scnb_f) in sorted(pair14.items()):
        exc_index.append((i_, j_))
        exc_qq.append(charges[i_] * charges[j_] / scee_f)
        exc_sig.append(0.5 * (sigmas[i_] + sigmas[j_]))
        exc_eps.append(np.sqrt(epsilons[i_] * epsilons[j_]) / scnb_f)
    exc_arr = np.asarray(exc_index, dtype=np.int64).reshape(-1, 2)

    periodic = nonbonded_method in ("cutoff_periodic", "pme", "ewald")
    default_box = None
    if periodic:
        if "BOX_DIMENSIONS" not in data:
            raise ValueError("periodic method requested but prmtop has no "
                             "BOX_DIMENSIONS")
        box_lengths = data["BOX_DIMENSIONS"][1:4] * A2NM  # [angle, a, b, c]
        default_box = tensor(np.diag(box_lengths))
    ewald = nonbonded_method in ("pme", "ewald")
    nonbonded = NonbondedTerm(
        charge=tensor(charges), sigma=tensor(sigmas),
        epsilon=tensor(epsilons),
        exception_index=tensor(exc_arr, np.int32),
        exception_chargeprod=tensor(exc_qq),
        exception_sigma=tensor(exc_sig),
        exception_epsilon=tensor(exc_eps),
        method=nonbonded_method,
        cutoff=None if nonbonded_method == "no_cutoff" else cutoff,
        switch_width=switch_width,
        use_dispersion_correction=periodic,
        ewald_alpha=(float(ewald_alpha(cutoff, ewald_error_tolerance))
                     if ewald else None))

    terms = [bond_terms, angle_terms, torsion_terms, nonbonded]
    if ewald:
        terms.append(make_ewald_reciprocal_term(
            charges, float(np.max(box_lengths)), cutoff, exc_arr,
            tol=ewald_error_tolerance, device=device))
    if implicit_solvent:
        if "RADII" not in data or "SCREEN" not in data:
            raise ValueError("prmtop lacks RADII/SCREEN for implicit solvent")
        model = gb_model.upper()
        if model not in ("HCT", "OBC1", "OBC2"):
            raise ValueError(f"unsupported gb_model {gb_model!r}; "
                             "available: HCT, OBC1, OBC2")
        a_, b_, g_ = OBC1 if model == "OBC1" else OBC2
        terms.append(GBSAOBCTerm(
            charge=tensor(charges),
            radius=tensor(data["RADII"][:natom] * A2NM),
            scale=tensor(data["SCREEN"][:natom]),
            obc_alpha=a_, obc_beta=b_, obc_gamma=g_,
            hct=(model == "HCT")))
    return System(masses=tensor(masses), terms=tuple(terms),
                  constraints=constraints_obj, default_box=default_box,
                  periodic=periodic)


def data_file(data_dir, subdir, name):
    """The path of a reference data file under ``data_dir`` (default
    ``DEFAULT_DATA_DIR``, read at the call); FileNotFoundError when it is
    absent."""
    path = os.path.join(data_dir or DEFAULT_DATA_DIR, subdir, name)
    if not os.path.exists(path):
        raise FileNotFoundError(f"data not found: {path}; set "
                                "OPENMMTOOLS_TPU_DATA")
    return path


def load_prmtop_system(ts, prmtop, positions, **options):
    """Fill the test system ``ts`` from a prmtop path and positions (nm):
    its system (``create_system_from_prmtop`` with ``options``) on
    ``ts.device``, float32 positions, topology and degrees of freedom. The
    file is parsed once for the system and the topology."""
    data = parse_prmtop(prmtop)
    ts.system = system_from_prmtop_data(data, device=ts.device, **options)
    n = ts.system.n_particles
    ts.positions = torch.as_tensor(
        np.asarray(positions[:n], dtype=np.float32), device=ts.device)
    ts.topology = AmberTopology(data)
    ts.ndof = 3 * n - ts.system.constraints.n_constraints


class AmberTopology:
    """Atom and residue names parsed from a prmtop, for selections."""

    def __init__(self, data: Dict[str, np.ndarray]):
        natom = int(data["POINTERS"][0])
        self.atom_names = list(data.get("ATOM_NAME", [])[:natom])
        res_labels = list(data.get("RESIDUE_LABEL", []))
        res_ptr = list(data.get("RESIDUE_POINTER", np.asarray([1]))
                       .astype(np.int64))
        self.residue_names = []
        self.residue_index = np.zeros(natom, dtype=np.int64)
        bounds = res_ptr + [natom + 1]
        for r in range(len(res_ptr)):
            lo, hi = bounds[r] - 1, bounds[r + 1] - 1
            self.residue_index[lo:hi] = r
            self.residue_names.append(res_labels[r] if r < len(res_labels)
                                      else "UNK")

    def select(self, expr=None, resname=None, name=None):
        """Atom selection: either keyword filters (``resname=``/``name=``)
        or an mdtraj-style expression string, e.g.
        ``select("protein and name CA")``,
        ``select("water or resname NA+")``,
        ``select("not hydrogen and resid 0 to 9")``.
        Returns sorted atom indices."""
        if expr is not None:
            return np.flatnonzero(_parse_selection(expr, self))
        idx = np.arange(len(self.atom_names))
        mask = np.ones(len(self.atom_names), dtype=bool)
        if resname is not None:
            rn = np.asarray([self.residue_names[r]
                             for r in self.residue_index])
            mask &= rn == resname
        if name is not None:
            mask &= np.asarray(self.atom_names) == name
        return idx[mask]


# -- mdtraj-style selection DSL ---------------------------------------------
# Recursive descent over: and/or/not, parentheses, bare keywords (all,
# none, protein, water, backbone, sidechain, hydrogen, heavy) and field
# selectors (name/resname with one or more values; resid/index with values
# or "A to B" ranges).

_PROTEIN_RESIDUES = frozenset("""
    ALA ARG ASN ASP CYS CYX CYM GLN GLU GLY HIS HID HIE HIP ILE LEU LYS MET
    PHE PRO SER THR TRP TYR VAL ACE NME NMA ASH GLH LYN
""".split())
_WATER_RESIDUES = frozenset(["WAT", "HOH", "TIP3", "TP3", "TIP4", "TIP5",
                             "SPC", "SOL"])
_BACKBONE_NAMES = frozenset(["CA", "C", "N", "O", "OXT"])


class _SelTokens:
    def __init__(self, expr):
        self.toks = re.findall(r"\(|\)|[^\s()]+", expr)
        self.pos = 0

    def peek(self):
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self):
        t = self.peek()
        if t is None:
            raise ValueError("unexpected end of selection expression")
        self.pos += 1
        return t


def _parse_selection(expr, top: AmberTopology):
    n = len(top.atom_names)
    names = np.asarray(top.atom_names)
    resnames = np.asarray([top.residue_names[r] for r in top.residue_index])
    resid = top.residue_index
    index = np.arange(n)
    is_h = np.asarray([s.strip().upper().lstrip("0123456789").startswith("H")
                       for s in top.atom_names])
    keywords = {
        "all": np.ones(n, bool),
        "none": np.zeros(n, bool),
        "protein": np.isin(resnames, list(_PROTEIN_RESIDUES)),
        "water": np.isin(resnames, list(_WATER_RESIDUES)),
        "hydrogen": is_h,
        "heavy": ~is_h,
    }
    keywords["backbone"] = keywords["protein"] & np.isin(
        names, list(_BACKBONE_NAMES))
    keywords["sidechain"] = keywords["protein"] & ~np.isin(
        names, list(_BACKBONE_NAMES))
    stop_words = {"and", "or", "not", "(", ")", "to"}
    fields = {"name", "resname", "resid", "index", "resSeq"}

    tk = _SelTokens(expr)

    def parse_or():
        m = parse_and()
        while tk.peek() == "or":
            tk.next()
            m = m | parse_and()
        return m

    def parse_and():
        m = parse_not()
        while tk.peek() == "and":
            tk.next()
            m = m & parse_not()
        return m

    def parse_not():
        if tk.peek() == "not":
            tk.next()
            return ~parse_not()
        return parse_primary()

    def parse_primary():
        t = tk.next()
        if t == "(":
            m = parse_or()
            if tk.next() != ")":
                raise ValueError("unbalanced parentheses in selection")
            return m
        if t in keywords:
            return keywords[t]
        if t in fields:
            vals = []
            while tk.peek() is not None and tk.peek() not in stop_words \
                    and tk.peek() not in fields:
                vals.append(tk.next())
                if tk.peek() == "to":           # range: "resid 2 to 7"
                    tk.next()
                    hi = tk.next()
                    arr = resid if t in ("resid", "resSeq") else index
                    return (arr >= int(vals[-1])) & (arr <= int(hi))
            if not vals:
                raise ValueError(f"selection field {t!r} needs a value")
            if t in ("resid", "resSeq"):
                return np.isin(resid, [int(v) for v in vals])
            if t == "index":
                return np.isin(index, [int(v) for v in vals])
            arr = names if t == "name" else resnames
            return np.isin(arr, vals)
        raise ValueError(f"unknown selection token {t!r}")

    mask = parse_or()
    if tk.peek() is not None:
        raise ValueError(f"trailing tokens in selection: {tk.toks[tk.pos:]}")
    return mask
