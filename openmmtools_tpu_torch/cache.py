"""Caches of bound integrators: the ContextCache counterpart (``cache.py``).

openmmtools' ``ContextCache`` is the GPU memory manager of its framework:
an LRU of live OpenMM Contexts keyed by (system, integrator), recycling the
device allocations across compatible states. Here a Context is a
:class:`~openmmtools_tpu_torch.integrators.langevin.BoundIntegrator`: the
step program, its constraint solvers and, on a large periodic system, sweep
mode's set-up (the kernel, the sorted parameter rows, the dispersion tail).
So this module provides

* :class:`LRUCache`: capacity and time-to-live counted in accesses, the
  reference's semantics;
* :class:`ContextCache`: ``get_context(thermodynamic_state, integrator)``
  returns ``(bound_integrator, thermodynamic_state)``;
* :class:`DummyContextCache`: a fresh binding every call;
* ``global_context_cache``: the module's singleton.

The cache is keyed by content: the system's ``fingerprint`` (a hash of its
tensors) and device, the ensemble's structure (NVT or NPT, surface tension, the global
parameter names) and the integrator's class and settings. The JAX package
keys by structure (tree shape and leaf shapes), which suits compiled
programs; a bound integrator holds the system's tensors (the sweep's
per-atom rows, a restraint's reference positions), so two systems of equal
shapes must not share one. The temperature is no part of the key: the bound
integrators take it from the state at ``initial_state``.

A Metropolized move, the barostat and the minimizer ask the cache for a
context bound to their state (``get_context(state)``, no integrator) and
evaluate energies there (``energies_at``, ``energy_forces_at``): sweep mode
and the sweep kernel on a large periodic system on the card, never the
dense O(N^2) sum. As in the reference, ``get_context`` with no integrator
returns any cached context of the state's system and ensemble, else binds
the cache's default integrator: a ``LangevinIntegrator`` at the state's
temperature, built with the keyword arguments the cache was made with
(``ContextCache(sweep="force")`` engages sweep mode on the CPU).
"""
from __future__ import annotations

import inspect
from typing import Any, Dict, Optional


class LRUCache:
    """Least-recently-used cache with an optional capacity and a
    time-to-live counted in accesses (reads that hit and writes).

    >>> cache = LRUCache(capacity=2)
    >>> cache['a'] = 1
    >>> cache['b'] = 2
    >>> cache['c'] = 3   # evicts 'a'
    >>> 'a' in cache
    False
    """

    def __init__(self, capacity: Optional[int] = None,
                 time_to_live: Optional[int] = None):
        self._data: Dict[Any, Any] = {}
        self._order: Dict[Any, int] = {}
        self._expirations: Dict[Any, int] = {}
        self._capacity = capacity
        self._ttl = time_to_live
        self._n_access = 0

    @property
    def capacity(self):
        return self._capacity

    @capacity.setter
    def capacity(self, value):
        self._capacity = value
        while value is not None and len(self._data) > value:
            self._evict_oldest()

    @property
    def time_to_live(self):
        return self._ttl

    @time_to_live.setter
    def time_to_live(self, value):
        # a new ttl re-assigns every entry's expiration, then purges
        if value == self._ttl:
            return
        if self._ttl is None:
            # entries had no expiration: they live `value` more accesses
            self._expirations = {k: self._n_access + value for k in self._data}
        elif value is None:
            self._expirations = {}
        else:
            delta = value - self._ttl
            self._expirations = {k: exp + delta
                                 for k, exp in self._expirations.items()}
        self._ttl = value
        self._flush_expired()

    def __len__(self):
        return len(self._data)

    def __contains__(self, key):
        return key in self._data

    def __getitem__(self, key):
        # the access counter moves only on a read that hits, and the entry's
        # expiration is refreshed before the purge: a read never expires
        # the entry it returns
        value = self._data[key]
        self._n_access += 1
        self._order[key] = self._n_access
        if self._ttl is not None:
            self._expirations[key] = self._n_access + self._ttl
            self._flush_expired()
        return value

    def __setitem__(self, key, value):
        self._n_access += 1
        self._flush_expired()
        self._data[key] = value
        self._order[key] = self._n_access
        if self._ttl is not None:
            self._expirations[key] = self._n_access + self._ttl
        if self._capacity is not None and len(self._data) > self._capacity:
            self._evict_oldest()

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def pop(self, key):
        self._order.pop(key, None)
        self._expirations.pop(key, None)
        return self._data.pop(key)

    def keys(self):
        return self._data.keys()

    def _evict_oldest(self):
        oldest = min(self._order, key=self._order.get)
        self.pop(oldest)

    def _flush_expired(self):
        if self._ttl is None:
            return
        dead = [k for k, exp in self._expirations.items()
                if exp <= self._n_access]
        for k in dead:
            self.pop(k)


def _state_key(thermodynamic_state):
    """The content of a state that a bound integrator depends on: its
    system's fingerprint, the device its tensors are on (a copy of the
    system on another card binds its own) and its ensemble's structure."""
    ts = thermodynamic_state
    return (ts.system.fingerprint, str(ts.system.device),
            ts.pressure is not None,
            ts.surface_tension is not None,
            tuple(sorted(ts.global_params or {})))


def _integrator_key(integrator):
    """The integrator's class and settings, the temperature and the
    per-instance cache of bound integrators left out."""
    settings = tuple(sorted(
        (name, repr(value)) for name, value in vars(integrator).items()
        if name not in ("temperature", "_bound")))
    return (type(integrator).__module__, type(integrator).__qualname__,
            settings)


def _default_integrator(thermodynamic_state, integrator_kwargs):
    from openmmtools_tpu_torch.integrators.langevin import LangevinIntegrator

    return LangevinIntegrator(
        temperature=float(thermodynamic_state.temperature),
        **integrator_kwargs)


def _integrator_kwargs(kwargs):
    """The keyword arguments that ``LangevinIntegrator`` takes; the others
    (the reference's platform and the like) mean nothing here."""
    from openmmtools_tpu_torch.integrators.langevin import LangevinIntegrator

    accepted = inspect.signature(LangevinIntegrator.__init__).parameters
    return {k: v for k, v in kwargs.items()
            if k in accepted and k != "temperature"}


class ContextCache:
    """LRU cache of bound integrators keyed by content (module docstring).

    ``get_context(thermodynamic_state, integrator=None)`` returns
    ``(bound_integrator, thermodynamic_state)``, the analog of the
    reference's (context, integrator) pair. Two states of one system and
    ensemble share a bound integrator, as the reference shares a Context
    across a lambda ladder; any other system, ensemble or integrator
    setting binds its own. Keyword arguments that ``LangevinIntegrator``
    takes configure the default integrator; others are ignored.
    """

    def __init__(self, capacity: Optional[int] = None,
                 time_to_live: Optional[int] = None, **kwargs):
        self._lru = LRUCache(capacity, time_to_live)
        self._integrator_kwargs = _integrator_kwargs(kwargs)

    def __len__(self):
        return len(self._lru)

    @property
    def capacity(self):
        return self._lru.capacity

    @capacity.setter
    def capacity(self, value):
        self._lru.capacity = value

    @property
    def time_to_live(self):
        return self._lru.time_to_live

    @time_to_live.setter
    def time_to_live(self, value):
        self._lru.time_to_live = value

    def empty(self):
        self._lru = LRUCache(self._lru.capacity, self._lru.time_to_live)

    @property
    def integrator_kwargs(self):
        """The keyword arguments of the default integrator, which callers
        that build their own integrator for this cache (the equilibration
        stages) apply too."""
        return dict(self._integrator_kwargs)

    def bound_integrators(self):
        """The cached bound integrators, oldest entry first."""
        return [self._lru._data[k] for k in self._lru.keys()]

    def get_context(self, thermodynamic_state, integrator=None):
        state_key = _state_key(thermodynamic_state)
        if integrator is None:
            # any context of this system and ensemble, most recent first
            for key in sorted(self._lru.keys(),
                              key=self._lru._order.get, reverse=True):
                if key[0] == state_key:
                    return self._lru[key], thermodynamic_state
            integrator = _default_integrator(thermodynamic_state,
                                             self._integrator_kwargs)
        key = (state_key, _integrator_key(integrator))
        bound = self._lru.get(key)
        if bound is None:
            bound = integrator.bind(thermodynamic_state.system)
            self._lru[key] = bound
        return bound, thermodynamic_state


class DummyContextCache:
    """Keeps nothing: each call binds its integrator (a fresh default one
    when none is given) to the state's system."""

    def __init__(self, **kwargs):
        self._integrator_kwargs = _integrator_kwargs(kwargs)

    integrator_kwargs = ContextCache.integrator_kwargs

    def get_context(self, thermodynamic_state, integrator=None):
        if integrator is None:
            integrator = _default_integrator(thermodynamic_state,
                                             self._integrator_kwargs)
        return integrator.bind(thermodynamic_state.system), thermodynamic_state


global_context_cache = ContextCache(capacity=None, time_to_live=None)
