"""Thermodynamic and sampler states (counterpart of ``states.py``).

* ``SamplerState`` {positions, velocities, box_vectors} and
  ``ThermodynamicState`` {system, temperature, pressure, surface_tension,
  global_params}: the ensemble is its fields (pressure None means NVT).
* ``reduced_potential`` u = beta (U + p V - gamma A), and its value at a
  list of states or for a list of configurations
  (:func:`reduced_potential_at_states`, :func:`reduced_potential_matrix`)
  as plain loops over the states.
* ``GlobalParameterState`` and ``CompoundThermodynamicState``: composable
  states contribute entries to the ``global_params`` dict that the energy
  terms read; parameters may be enslaved to math expressions of function
  variables (:class:`GlobalParameterFunction`).
* :func:`create_thermodynamic_state_protocol` builds a ladder of states.
* :func:`is_state_compatible` / :func:`group_by_compatibility`: states whose
  systems have the same structure (term types, static fields, tensor shapes
  and dtypes) and the same ensemble structure;
  :func:`stack_thermodynamic_states` gives the per-state scalars of K
  compatible states as (K,) float64 host tensors, the form the multistate
  samplers read (they keep the list of states beside it).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from openmmtools_tpu_torch.constants import BAR_TO_KJ_PER_MOL_NM3, kB
from openmmtools_tpu_torch.system import System, kinetic_energy, make_energy_fn, volume
from openmmtools_tpu_torch.utils.math_eval import math_eval
from openmmtools_tpu_torch.utils.pytree import tensor_dataclass


class ThermodynamicsError(Exception):
    """Raised on inconsistent thermodynamic specifications."""


class SamplerStateError(Exception):
    """Raised on inconsistent sampler-state operations."""


def compute_reduced_potential(potential_energy, beta, volume=None,
                              pressure=None, area=None, surface_tension=None):
    """u = beta [U + p V - gamma A]: pressure in bar, volume in nm^3,
    energies in kJ/mol, surface tension in bar nm."""
    u = potential_energy
    if pressure is not None:
        u = u + pressure * BAR_TO_KJ_PER_MOL_NM3 * volume
    if surface_tension is not None:
        u = u - surface_tension * BAR_TO_KJ_PER_MOL_NM3 * area
    return beta * u


@tensor_dataclass
class SamplerState:
    """Configurational state: positions, velocities, box vectors."""

    positions: torch.Tensor                       # (N, 3) nm
    velocities: Optional[torch.Tensor] = None     # (N, 3) nm/ps
    box_vectors: Optional[torch.Tensor] = None    # (3, 3) nm

    def __post_init__(self):
        p, v = self.positions, self.velocities
        if v is not None and p.shape[-2] != v.shape[-2]:
            raise SamplerStateError(
                f"inconsistent velocities: shape {tuple(v.shape)} does not "
                f"match positions {tuple(p.shape)}")

    @property
    def n_particles(self) -> int:
        return self.positions.shape[-2]

    @property
    def volume(self):
        if self.box_vectors is None:
            return None
        return volume(self.box_vectors)

    def has_nan(self) -> torch.Tensor:
        """True if positions (or velocities) contain NaN or inf."""
        bad = torch.any(~torch.isfinite(self.positions))
        if self.velocities is not None:
            bad = bad | torch.any(~torch.isfinite(self.velocities))
        return bad


@tensor_dataclass
class ThermodynamicState:
    """Ensemble definition: system + temperature (+ pressure, surface
    tension) + global parameters (lambdas etc.). NVT: pressure=None."""

    system: System
    temperature: Any                              # K
    pressure: Optional[Any] = None                # bar
    surface_tension: Optional[Any] = None         # bar nm
    global_params: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def n_particles(self) -> int:
        return self.system.n_particles

    @property
    def kT(self):
        return kB * self.temperature

    @property
    def beta(self):
        return 1.0 / (kB * self.temperature)

    @property
    def volume(self):
        """Volume of the default box for NVT states (None under NPT, where
        the volume belongs to the sampler state)."""
        if self.pressure is not None or self.system.default_box is None:
            return None
        return volume(self.system.default_box)

    def potential_energy(self, sampler_state: SamplerState):
        box = sampler_state.box_vectors
        if box is None:
            box = self.system.default_box
        return make_energy_fn(self.system)(
            sampler_state.positions, box, self.global_params)

    def kinetic_energy(self, sampler_state: SamplerState):
        if sampler_state.velocities is None:
            raise SamplerStateError("sampler state has no velocities")
        return kinetic_energy(self.system.masses, sampler_state.velocities)

    def reduced_potential(self, sampler_state: SamplerState):
        """u(x) = beta [U(x) + p V(x) - gamma A(x)]."""
        U = self.potential_energy(sampler_state)
        area = None
        if (self.surface_tension is not None
                and sampler_state.box_vectors is not None):
            b = sampler_state.box_vectors
            area = 2.0 * b[0, 0] * b[1, 1]  # xy area, both leaflets
        return compute_reduced_potential(
            U, self.beta, volume=sampler_state.volume, pressure=self.pressure,
            area=area, surface_tension=self.surface_tension)


def reduced_potential_at_states(sampler_state: SamplerState, states):
    """u_k: the reduced potential of one configuration at each of the K
    states (thermodynamic or compound states sharing one system), as a (K,)
    tensor."""
    return torch.stack([torch.as_tensor(s.reduced_potential(sampler_state))
                        for s in states])


def reduced_potential_matrix(sampler_states: Sequence[SamplerState], states):
    """u[n, k] for N configurations at K states, an (N, K) tensor."""
    return torch.stack([reduced_potential_at_states(ss, states)
                        for ss in sampler_states])


def create_thermodynamic_state_protocol(
    reference_state,
    protocol: Mapping[str, Sequence],
    constants: Optional[Mapping[str, Any]] = None,
) -> List[ThermodynamicState]:
    """A ladder of states varying attributes or global parameters.

    ``protocol`` maps names ('temperature', 'pressure', 'surface_tension' or
    any global parameter name) to equal-length sequences of values;
    ``constants`` apply to every state. A compound reference state is
    resolved into its global parameters first."""
    if isinstance(reference_state, CompoundThermodynamicState):
        reference_state = reference_state.resolve()
    constants = dict(constants or {})
    lengths = {len(v) for v in protocol.values()}
    if len(lengths) != 1:
        raise ValueError(f"protocol sequences have different lengths: {lengths}")
    if 0 in lengths:
        raise ValueError("protocol sequences are empty")
    n_states = lengths.pop()

    states = []
    for i in range(n_states):
        values = dict(constants)
        values.update({k: v[i] for k, v in protocol.items()})
        temperature = values.pop("temperature", reference_state.temperature)
        pressure = values.pop("pressure", reference_state.pressure)
        surface_tension = values.pop("surface_tension",
                                     reference_state.surface_tension)
        gp = dict(reference_state.global_params)
        gp.update(values)
        states.append(ThermodynamicState(
            system=reference_state.system, temperature=temperature,
            pressure=pressure, surface_tension=surface_tension,
            global_params=gp))
    return states



# ---------------------------------------------------------------------------
# compatibility and stacks of states
# ---------------------------------------------------------------------------


def _structure(value):
    """The structure of a tree of dataclasses and tensors: classes, field
    names, static values and tensor shapes and dtypes, no tensor data."""
    if isinstance(value, torch.Tensor):
        return ("tensor", tuple(value.shape), str(value.dtype))
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return (type(value).__name__,) + tuple(
            (f.name, _structure(getattr(value, f.name)))
            for f in dataclasses.fields(value))
    if isinstance(value, (tuple, list)):
        return (type(value).__name__,) + tuple(_structure(v) for v in value)
    if isinstance(value, dict):
        return ("dict",) + tuple((k, _structure(value[k]))
                                 for k in sorted(value))
    return ("value", repr(value))


def _signature(state):
    if isinstance(state, CompoundThermodynamicState):
        state = state.resolve()
    ensemble = (state.pressure is not None, state.surface_tension is not None,
                tuple(sorted(state.global_params)))
    return (_structure(state.system), ensemble)


def is_state_compatible(state1, state2) -> bool:
    """True when one program evaluates both states: the same system
    structure (term classes, static fields, tensor shapes and dtypes) and
    the same ensemble structure (NVT or NPT, surface tension, the names of
    the global parameters)."""
    return _signature(state1) == _signature(state2)


def group_by_compatibility(states: Sequence):
    """Group states by compatibility, in order within each group. Returns
    (groups, original_indices)."""
    groups: List[List[Any]] = []
    indices: List[List[int]] = []
    sigs: List[Any] = []
    for i, s in enumerate(states):
        sig = _signature(s)
        for gi, known in enumerate(sigs):
            if known == sig:
                groups[gi].append(s)
                indices[gi].append(i)
                break
        else:
            sigs.append(sig)
            groups.append([s])
            indices.append([i])
    return groups, indices


def _scalar(value) -> float:
    return float(value.item() if isinstance(value, torch.Tensor) else value)


@dataclasses.dataclass(frozen=True)
class StackedThermodynamicStates:
    """The per-state scalars of K compatible states sharing the first
    state's system: temperature (K,), pressure (K,) or None, surface
    tension (K,) or None, and each global parameter (K,), all float64
    tensors on the host."""

    system: System
    temperature: torch.Tensor
    pressure: Optional[torch.Tensor]
    surface_tension: Optional[torch.Tensor]
    global_params: Dict[str, torch.Tensor]

    @property
    def n_states(self) -> int:
        return self.temperature.shape[0]

    @property
    def beta(self) -> torch.Tensor:
        return 1.0 / (kB * self.temperature)


def stack_thermodynamic_states(states: Sequence) -> StackedThermodynamicStates:
    """Stack K compatible states (plain or compound) into their (K,)
    per-state scalars; the system is the first state's."""
    if not states:
        raise ValueError("empty state list")
    states = [s.resolve() if isinstance(s, CompoundThermodynamicState) else s
              for s in states]
    first = states[0]
    for s in states[1:]:
        if not is_state_compatible(first, s):
            raise ThermodynamicsError("cannot stack incompatible states")

    def column(values):
        return torch.tensor([_scalar(v) for v in values], dtype=torch.float64)

    return StackedThermodynamicStates(
        system=first.system,
        temperature=column(s.temperature for s in states),
        pressure=(None if first.pressure is None
                  else column(s.pressure for s in states)),
        surface_tension=(None if first.surface_tension is None
                         else column(s.surface_tension for s in states)),
        global_params={name: column(s.global_params[name] for s in states)
                       for name in first.global_params})

# ---------------------------------------------------------------------------
# GlobalParameterState / CompoundThermodynamicState
# ---------------------------------------------------------------------------


class GlobalParameterError(Exception):
    """Raised on invalid global-parameter operations."""


class GlobalParameterFunction:
    """A global parameter enslaved to a math expression of function
    variables.

    >>> f = GlobalParameterFunction('lambda**2')
    """

    def __init__(self, expression: str):
        self.expression = expression

    def __call__(self, variables: Mapping[str, Any]):
        return math_eval(self.expression, variables)

    def __repr__(self):
        return f"GlobalParameterFunction({self.expression!r})"


class GlobalParameter:
    """Descriptor declaring a controlled global parameter on a
    GlobalParameterState subclass."""

    def __init__(self, parameter_name: str, standard_value,
                 validator: Optional[Callable] = None):
        self.parameter_name = parameter_name
        self.standard_value = standard_value
        self.validator = validator

    def __set_name__(self, owner, name):
        self.attr_name = name

    def __get__(self, instance, owner):
        if instance is None:
            return self
        return instance.get_parameter(self.parameter_name)

    def __set__(self, instance, value):
        instance.set_parameter(self.parameter_name, value)


class GlobalParameterState:
    """Composable state controlling a set of global parameters.

    Subclasses declare parameters with :class:`GlobalParameter` descriptors;
    instances hold values (None = parameter not controlled), support a name
    suffix for multi-region control, validators, and parameters enslaved to
    :class:`GlobalParameterFunction` expressions of function variables.
    """

    _GLOBAL_PARAMETERS: Dict[str, GlobalParameter] = {}

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        params = {}
        for klass in reversed(cls.__mro__):
            for value in vars(klass).values():
                if isinstance(value, GlobalParameter):
                    params[value.parameter_name] = value
        cls._GLOBAL_PARAMETERS = params

    def __init__(self, parameters_name_suffix: Optional[str] = None, **kwargs):
        self._parameters: Dict[str, Any] = {}
        self._function_variables: Dict[str, Any] = {}
        self._suffix = parameters_name_suffix
        base = type(self)._GLOBAL_PARAMETERS
        for base_name in base:
            self._parameters[self._suffixed(base_name)] = None
        for key, value in kwargs.items():
            if key not in base:
                raise GlobalParameterError(
                    f"unknown parameter {key!r}; known: {sorted(base)}")
            self.set_parameter(self._suffixed(key), value)

    # -- naming ------------------------------------------------------------
    def _suffixed(self, base_name: str) -> str:
        if self._suffix is None:
            return base_name
        return f"{base_name}_{self._suffix}"

    def _base_name(self, name: str) -> str:
        if self._suffix is not None and name.endswith("_" + self._suffix):
            return name[: -len(self._suffix) - 1]
        return name

    @property
    def parameters_name_suffix(self):
        return self._suffix

    # -- access ------------------------------------------------------------
    def get_parameter(self, name: str):
        name = (self._suffixed(name) if name in type(self)._GLOBAL_PARAMETERS
                else name)
        value = self._parameters[name]
        if isinstance(value, GlobalParameterFunction):
            return value(self._function_variables)
        return value

    def set_parameter(self, name: str, value):
        base = type(self)._GLOBAL_PARAMETERS
        lookup = self._base_name(name) if name in self._parameters else name
        if lookup in base and name not in self._parameters:
            name = self._suffixed(lookup)
        if name not in self._parameters:
            raise GlobalParameterError(
                f"{name!r} is not controlled by this state")
        descriptor = base[self._base_name(name)]
        if value is not None and not isinstance(value, GlobalParameterFunction):
            if descriptor.validator is not None:
                value = descriptor.validator(self, value)
        self._parameters[name] = value

    def set_function_variable(self, name: str, value):
        """Set a variable usable inside GlobalParameterFunction expressions."""
        self._function_variables[name] = value

    def get_function_variable(self, name: str):
        return self._function_variables[name]

    @property
    def parameters(self) -> Dict[str, Any]:
        """Resolved {name: value} for controlled (non-None) parameters."""
        out = {}
        for name, value in self._parameters.items():
            if value is None:
                continue
            if isinstance(value, GlobalParameterFunction):
                value = value(self._function_variables)
            out[name] = value
        return out

    # -- the composable-state protocol ---------------------------------------
    def apply_to_state(self, thermo: ThermodynamicState) -> ThermodynamicState:
        gp = dict(thermo.global_params)
        gp.update(self.parameters)
        return thermo.replace(global_params=gp)

    @staticmethod
    def _system_global_defaults(system: System) -> Dict[str, Any]:
        """{name: default value} of every global parameter a System's terms
        declare."""
        defaults: Dict[str, Any] = {}
        for term in system.terms:
            gd = getattr(term, "global_defaults", None)
            if isinstance(gd, dict):
                defaults.update(gd)
            for attr in ("charge_scale_param", "lj_scale_param"):
                pname = getattr(term, attr, None)
                if pname is not None:
                    defaults.setdefault(pname, 1.0)
        return defaults

    @classmethod
    def from_system(cls, system: System, parameters_name_suffix=None):
        """Read the controlled parameters' defaults out of a System's
        terms."""
        defaults = cls._system_global_defaults(system)
        instance = cls(parameters_name_suffix=parameters_name_suffix)
        found = False
        for name in list(instance._parameters):
            if name in defaults:
                instance.set_parameter(name, defaults[name])
                found = True
        if not found:
            raise GlobalParameterError(
                f"system defines none of the parameters "
                f"{sorted(instance._parameters)}")
        return instance

    def check_system_consistency(self, system: System) -> None:
        """Raise GlobalParameterError unless the system's declared global
        parameters match this state: every resolved parameter exists in the
        system at the same value, and the system declares no parameter this
        state controls but has set to None."""
        defaults = self._system_global_defaults(system)
        for name, value in self.parameters.items():
            if name not in defaults:
                raise GlobalParameterError(
                    f"Consistency check failed: could not find global "
                    f"parameter {name} in the system")
            if abs(float(defaults[name]) - float(value)) > (
                    1e-8 + 1e-5 * abs(float(value))):
                raise GlobalParameterError(
                    f"Consistency check failed: {name} is "
                    f"{defaults[name]!r} in the system but {value!r} in "
                    f"this state")
        for name in defaults:
            if name in self._parameters and self._parameters[name] is None:
                raise GlobalParameterError(
                    f"Consistency check failed: the system parameter {name} "
                    f"is undefined (None) in this state")

    def __eq__(self, other):
        # function-valued parameters compare by their resolved values;
        # parameters set to None drop out of ``parameters``, so states
        # controlling different subsets compare unequal
        return (type(self) is type(other)
                and self._suffix == other._suffix
                and set(self._parameters) == set(other._parameters)
                and self.parameters == other.parameters)

    def __repr__(self):
        vals = ", ".join(f"{k}={v!r}" for k, v in self._parameters.items())
        return f"{type(self).__name__}({vals})"


@tensor_dataclass
class CompoundThermodynamicState:
    """A ThermodynamicState with composable states on top.

    The composable states contribute global parameters; :meth:`resolve`
    gives the plain ThermodynamicState whose ``global_params`` the energy
    terms read. Attribute reads go to the composable states first, then to
    the base state."""

    base_state: ThermodynamicState
    composable_states: Tuple[Any, ...] = ()

    def resolve(self) -> ThermodynamicState:
        state = self.base_state
        for cs in self.composable_states:
            state = cs.apply_to_state(state)
        return state

    def __getattr__(self, name):
        if name in ("base_state", "composable_states"):
            raise AttributeError(name)   # not yet set while being built
        for cs in self.composable_states:
            try:
                return cs.get_parameter(name)
            except (KeyError, GlobalParameterError, AttributeError):
                continue
        try:
            return getattr(self.base_state, name)
        except AttributeError:
            pass
        raise AttributeError(name)

    @property
    def temperature(self):
        return self.base_state.temperature

    @property
    def pressure(self):
        return self.base_state.pressure

    @property
    def system(self):
        return self.base_state.system

    @property
    def beta(self):
        return self.base_state.beta

    @property
    def kT(self):
        return self.base_state.kT

    @property
    def global_params(self):
        return self.resolve().global_params

    def reduced_potential(self, sampler_state: SamplerState):
        return self.resolve().reduced_potential(sampler_state)

    def potential_energy(self, sampler_state: SamplerState):
        return self.resolve().potential_energy(sampler_state)
