"""Model-definition files (port of ``model_parser.py`` and the model-file half of ``compat.py``).

A model file is a Python script whose bare component-constructor
expressions (``Sky(...)``, ``Sersic(...)``) each declare one model
component, as in the reference and the JAX package: the file's AST is
rewritten so every top-level bare expression appends its value to a
hidden accumulator list, the port's components and distributions are
injected into the namespace, the file executes with its own directory as
the working directory (image paths are file-relative), and every
``ComponentBase`` instance is collected in order.

Model files import their components by the reference's module names
(``psfMC.ModelComponents``, ``psfMC.distributions``) or the JAX
package's (``psfmc_tpu.models.components``, ``psfmc_tpu.distributions``).
All of them resolve to the port's modules through an ``__import__`` that
lives only in the executed file's namespace: unlike the JAX package's
shims, nothing is registered in ``sys.modules``, so a process that also
holds the JAX package or the repository's ``psfMC`` package keeps them
intact, and a file such as ``examples/model_example.py`` runs unmodified
where JAX is not installed.
"""
from __future__ import annotations

import ast
import builtins
import contextlib
import os
import types
import warnings

from . import distributions as _distributions
from .models import components as _components
from .models.components import ComponentBase

__all__ = ["component_list_from_file", "component_list_from_string"]

_ACC_NAME = "__psfmc_components__"


def _namespace_module(name, **attrs):
    """A module object for the ``import psfMC...`` forms; never registered
    in ``sys.modules``."""
    mod = types.ModuleType(name)
    for key, val in attrs.items():
        setattr(mod, key, val)
    return mod


# the package roots a model file may import from, as the port's modules
_ROOTS = {
    "psfMC": _namespace_module(
        "psfMC", ModelComponents=_components, distributions=_distributions),
    "psfmc_tpu": _namespace_module(
        "psfmc_tpu", ModelComponents=_components, distributions=_distributions,
        models=_namespace_module("psfmc_tpu.models", components=_components)),
}


def _model_import(name, globals=None, locals=None, fromlist=(), level=0):
    """``__import__`` of an executed model file: ``psfMC.*`` and
    ``psfmc_tpu.*`` component and distribution modules resolve to the
    port's; every other name imports as usual."""
    root, *rest = name.split(".")
    if level != 0 or root not in _ROOTS:
        return builtins.__import__(name, globals, locals, fromlist, level)
    obj = _ROOTS[root]
    for part in rest:
        obj = getattr(obj, part, None)
        if not isinstance(obj, types.ModuleType):
            raise ImportError(
                f"a model file may import the components and distributions "
                f"of {root} (the port's own), not {name!r}"
            )
    return obj if fromlist else _ROOTS[root]


class _CollectBareExprs(ast.NodeTransformer):
    """Rewrite module-level bare expressions into accumulator appends.

    Assignments are not collected (reference semantics): name a
    component AND mention it as a bare expression where it belongs.
    """

    def visit_Expr(self, node):
        call = ast.Call(
            func=ast.Attribute(
                value=ast.Name(id=_ACC_NAME, ctx=ast.Load()),
                attr="append", ctx=ast.Load(),
            ),
            args=[node.value], keywords=[],
        )
        return ast.copy_location(ast.Expr(value=call), node)


@contextlib.contextmanager
def _working_dir(path):
    prev = os.getcwd()
    if path:
        os.chdir(path)
    try:
        yield
    finally:
        os.chdir(prev)


def _fresh_namespace():
    scoped = dict(vars(builtins))
    scoped["__import__"] = _model_import
    ns = {"__builtins__": scoped, "__name__": "__psfmc_model__"}
    for mod in (_components, _distributions):
        ns.update({n: getattr(mod, n) for n in mod.__all__})
    ns[_ACC_NAME] = []
    return ns


def component_list_from_string(source, filename="<model>", model_dir=""):
    """Parse model source text; returns the list of ComponentBase instances."""
    tree = ast.parse(source)
    tree.body = [_CollectBareExprs().visit(node) for node in tree.body]
    ast.fix_missing_locations(tree)
    namespace = _fresh_namespace()
    code = compile(tree, filename, mode="exec")
    with _working_dir(model_dir):
        exec(code, namespace)

    out, seen = [], set()
    for comp in namespace[_ACC_NAME]:
        if isinstance(comp, ComponentBase) and id(comp) not in seen:
            seen.add(id(comp))
            out.append(comp)
    orphans = [name for name, val in namespace.items()
               if isinstance(val, ComponentBase) and id(val) not in seen]
    if orphans:
        warnings.warn(
            f"model file assigns component(s) {orphans} that are never "
            "mentioned as bare expressions — they are NOT included in the "
            "model.  Add the bare name on its own line where the component "
            "belongs."
        )
    return out


def component_list_from_file(filename):
    """Read a model file and return its component list."""
    with open(filename) as f:
        source = f.read()
    return component_list_from_string(
        source, filename=filename, model_dir=os.path.dirname(filename)
    )
