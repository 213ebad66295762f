"""API parity of the port with the JAX package, read from the sources.

Both packages are parsed with ``ast``; nothing is imported. For each module
of the JAX package, every public function, class and public method (one
that the port's class inherits counts) must have a counterpart at the same
path in the port, and every public name that a package ``__init__``
imports must be importable from the port's. The two Pallas modules map to
the port's wrappers of their kernels. The exceptions are named one by one
below, each with its reason; a name that the JAX package gains later, and
the port lacks, fails here.
"""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX = ROOT / "openmmtools_tpu"
PORT = ROOT / "openmmtools_tpu_torch"

# JAX module -> port module, where the port's path differs
MODULE_MAP = {
    "ops/pallas_baoab.py": "ops/fused_langevin.py",
    "ops/pallas_md.py": "ops/fused_md.py",
}

# whole modules that are not ported (ROADMAP.md, "Not to port")
NOT_PORTED_MODULES = {
    "ops/cellpair.py": "a refuted TPU experiment, reached only from tests",
    "scripts/tune_fused.py": "a TPU measurement script",
    "scripts/tune_dhfr.py": "a TPU measurement script",
    "scripts/tune_levers.py": "a TPU measurement script",
    "scripts/profile_recip.py": "a TPU measurement script",
    "scripts/profile_dhfr_step.py": "a TPU measurement script",
    "scripts/bench_recip_scaling.py": "a TPU measurement script",
    "scripts/bench_cellpair.py": "a TPU measurement script",
    "scripts/measure_tpu_pass.py": "a TPU measurement script",
}

# single names (ROADMAP.md, "Not to port" and "Left out on purpose")
NOT_PORTED_NAMES = {
    "states.py:unstack_thermodynamic_states":
        "the port stacks states into host columns "
        "(StackedThermodynamicStates)",
    "ops/geometry.py:gather_rows": "a TPU optimization barrier",
    "integrators/langevin.py:BoundIntegrator.step_fn": "a jitted step",
    "multistate/sampler.py:MultiStateCarry":
        "the JAX sampler's device carry; the port keeps the replicas' "
        "states on the sampler",
    "utils/pytree.py:pytree_dataclass":
        "the JAX pytree decorator; its counterpart is the port's "
        "tensor_dataclass",
}


def _jax_modules():
    return sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def _parse(path):
    return ast.parse(path.read_text(), filename=str(path))


def _top_level(tree):
    """The statements of a module's body, with those of its top-level
    ``if`` and ``try`` blocks."""
    out = []
    todo = list(tree.body)
    while todo:
        node = todo.pop(0)
        if isinstance(node, ast.If):
            todo[:0] = node.body + node.orelse
        elif isinstance(node, ast.Try):
            todo[:0] = (node.body + node.orelse + node.finalbody
                        + [s for h in node.handlers for s in h.body])
        else:
            out.append(node)
    return out


def _bound_names(body):
    """Every name a class or module body binds."""
    names = set()
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        names.add(n.id)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                             ast.Name):
            names.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                names.add((a.asname or a.name).split(".")[0])
    return names


def _public(name):
    return not name.startswith("_")


class _Port:
    """The port's modules, parsed once, and their classes' names through
    their bases."""

    def __init__(self):
        self.trees = {str(p.relative_to(PORT)): _parse(p)
                      for p in PORT.rglob("*.py")}

    def module_of(self, dotted):
        """The relative path of a port module named ``dotted``."""
        parts = dotted.split(".")[1:]
        for cand in ("/".join(parts) + ".py",
                     "/".join(parts + ["__init__.py"])):
            if cand in self.trees:
                return cand
        return None

    def find_class(self, module, name, seen=()):
        """The ClassDef of ``name`` as seen from ``module`` (defined there
        or imported into it), with the module that defines it."""
        tree = self.trees.get(module)
        if tree is None or (module, name) in seen:
            return None, None
        for node in _top_level(tree):
            if isinstance(node, ast.ClassDef) and node.name == name:
                return node, module
        for node in _top_level(tree):
            if isinstance(node, ast.ImportFrom) and node.module and (
                    node.module.startswith("openmmtools_tpu_torch")):
                for a in node.names:
                    if (a.asname or a.name) == name:
                        return self.find_class(
                            self.module_of(node.module), a.name,
                            seen + ((module, name),))
        return None, None

    def class_names(self, module, name):
        """Every name bound in class ``name``'s body or a base's."""
        node, where = self.find_class(module, name)
        if node is None:
            return None
        names = _bound_names(node.body)
        for base in node.bases:
            base_name = (base.id if isinstance(base, ast.Name)
                         else base.attr if isinstance(base, ast.Attribute)
                         else None)
            if base_name is None:
                continue
            inherited = self.class_names(where, base_name)
            if inherited:
                names |= inherited
        return names


@pytest.fixture(scope="module")
def port():
    return _Port()


def _missing(module, port):
    """The JAX module's public names without a counterpart in the port."""
    target = MODULE_MAP.get(module, module)
    jax_tree = _parse(JAX / module)
    port_tree = port.trees.get(target)
    assert port_tree is not None, f"no port module {target} for {module}"
    port_names = _bound_names(_top_level(port_tree))
    missing = []
    for node in _top_level(jax_tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if _public(node.name) and node.name not in port_names:
                missing.append(node.name)
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            if node.name not in port_names:
                missing.append(node.name)
                continue
            have = port.class_names(target, node.name)
            if have is None:     # bound, but not as a class of the port's
                have = set()
            for member in node.body:
                if (isinstance(member, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))
                        and _public(member.name)
                        and member.name not in have):
                    missing.append(f"{node.name}.{member.name}")
        elif (isinstance(node, ast.ImportFrom)
              and module.endswith("__init__.py")):
            # a package's exports
            for a in node.names:
                name = a.asname or a.name
                if _public(name) and name != "*" and name not in port_names:
                    missing.append(name)
    return [m for m in missing
            if f"{module}:{m}" not in NOT_PORTED_NAMES]


PORTED_MODULES = [m for m in _jax_modules() if m not in NOT_PORTED_MODULES]


@pytest.mark.parametrize("module", PORTED_MODULES)
def test_every_public_name_has_a_port(module, port):
    assert _missing(module, port) == []


def test_allow_list_names_only_what_the_jax_package_has(port):
    """Each exception names a module or a name that the JAX package still
    has and the port still lacks: a stale entry fails."""
    for module in NOT_PORTED_MODULES:
        assert (JAX / module).is_file(), module
        assert module not in port.trees, module
    for entry in NOT_PORTED_NAMES:
        module, name = entry.split(":")
        target = MODULE_MAP.get(module, module)
        jax_names = _bound_names(_top_level(_parse(JAX / module)))
        head, _, member = name.partition(".")
        assert head in jax_names, entry
        port_names = _bound_names(_top_level(port.trees[target]))
        if member:
            assert member not in (port.class_names(target, head) or set()), \
                entry
        else:
            assert head not in port_names, entry


KERNEL_NAMES = {
    "ops/pallas_baoab.py": {"FusedSortedLangevin", "FusedSortedBAOAB",
                            "FusedDenseBAOAB"},
    "ops/pallas_md.py": {"LJGridSpec", "make_grid_spec", "bin_particles",
                         "FusedLJBAOAB"},
}


@pytest.mark.parametrize("module", sorted(MODULE_MAP))
def test_the_pallas_modules_map_to_the_kernel_wrappers(module, port):
    """The public functions and classes of the two Pallas modules are
    defined in the port's wrappers of their kernels, the kernels' entry
    points among them."""
    def defined(tree):
        """Functions, classes and aliases (``A = B``) a module defines."""
        names = set()
        for n in _top_level(tree):
            if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
                names.add(n.name)
            elif isinstance(n, ast.Assign) and isinstance(n.value, ast.Name):
                names.update(t.id for t in n.targets
                             if isinstance(t, ast.Name))
        return {name for name in names if _public(name)}

    jax_names = defined(_parse(JAX / module))
    assert KERNEL_NAMES[module] <= jax_names
    missing = jax_names - defined(port.trees[MODULE_MAP[module]])
    assert not missing, missing


def test_the_guard_sees_a_missing_name(port, monkeypatch):
    """The check fails on a name the port lacks: a method taken out of a
    port class's body is reported."""
    tree = port.trees["states.py"]
    cls = next(n for n in _top_level(tree)
               if isinstance(n, ast.ClassDef)
               and n.name == "ThermodynamicState")
    kept = [n for n in cls.body if getattr(n, "name", None) != "beta"]
    monkeypatch.setattr(cls, "body", kept)
    assert "ThermodynamicState.beta" in _missing("states.py", port)
