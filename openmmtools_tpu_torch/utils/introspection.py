"""Class-hierarchy introspection (counterpart of ``utils/introspection.py``):
openmmtools' ``find_all_subclasses`` and ``find_subclass``."""
from __future__ import annotations

import inspect
from typing import Set


def find_all_subclasses(parent_cls: type, discard_abstract: bool = False,
                        include_parent: bool = True) -> Set[type]:
    """Every class that inherits, directly or not, from ``parent_cls``.

    ``discard_abstract`` drops abstract classes; ``include_parent`` adds
    ``parent_cls`` itself unless it is abstract (it is then never added).
    A set, so diamond inheritance counts each class once.
    """
    found: Set[type] = set()
    stack = [parent_cls]
    while stack:
        cls = stack.pop()
        for sub in cls.__subclasses__():
            if sub not in found:
                stack.append(sub)
            if not (discard_abstract and inspect.isabstract(sub)):
                found.add(sub)
    if include_parent and not inspect.isabstract(parent_cls):
        found.add(parent_cls)
    return found


def find_subclass(parent_cls: type, subcls_name: str) -> type:
    """The one subclass of ``parent_cls`` named ``subcls_name``; raises
    ``ValueError`` when no class, or more than one, has that name."""
    matches = [cls for cls in find_all_subclasses(parent_cls)
               if cls.__name__ == subcls_name]
    if not matches:
        raise ValueError(f"Could not find class {subcls_name} inheriting "
                         f"from {parent_cls}")
    if len(matches) > 1:
        raise ValueError(f"Found multiple classes named {subcls_name} "
                         f"inheriting from {parent_cls}: {matches}")
    return matches[0]
