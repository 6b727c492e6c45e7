"""AST-level lints over the port's sources (stdlib ``ast`` only — no
imports of the code under audit).

The port of the JAX package's ``repro.analysis.audit.ast_lint``. Rules:

* ``no_host_sync_in_graph`` — no ``.item()`` / ``.cpu()`` / ``.tolist()``
  / ``.numpy()`` call and no ``torch.cuda.synchronize`` inside a ``with
  torch.cuda.graph(...)`` block: a capture cannot sync with the host, and
  what it records would replay without the sync (the counterpart of the
  reference's ``no_host_sync_in_jit``).
* ``no_mutable_default_arg`` — no ``[]`` / ``{}`` / ``set()`` default
  argument values.
* ``no_bare_assert_in_kernels`` — ``kernels/`` raises typed
  ``KernelSpecError`` / ``PackedNodeError``; a bare ``assert`` there
  strips under ``python -O`` and reports no shapes.
* ``no_plain_backend_default`` — a parameter ``backend`` under
  ``kernels/`` must not default to ``"torch"``: that pins the plain
  PyTorch version and hides the kernel (the counterpart of the
  reference's ``no_interpret_default_true``).

Suppression: a line comment ``# audit: ignore[<rule>]`` (a rule name) on the
offending line (or the ``def`` line for defaults) skips that finding;
verbose runs surface every suppression so they stay visible.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Callable, Iterable, Optional

from .rules import Violation, register_catalog_rule

register_catalog_rule(
    "no_host_sync_in_graph", "ast",
    "No .item() / .cpu() / .tolist() / .numpy() / torch.cuda.synchronize() "
    "inside a `with torch.cuda.graph(...)` capture.")
register_catalog_rule(
    "no_mutable_default_arg", "ast",
    "No mutable default argument values ([] / {} / set()).")
register_catalog_rule(
    "no_bare_assert_in_kernels", "ast",
    "kernels/ must raise typed KernelSpecError/PackedNodeError instead "
    "of bare asserts (assert strips under -O and names no shapes).")
register_catalog_rule(
    "no_plain_backend_default", "ast",
    "No backend=\"torch\" parameter default under kernels/: the plain "
    "version must be an explicit opt-in, never the default of a kernel path.")

_IGNORE_RE = re.compile(r"#\s*audit:\s*ignore\[([\w,\s]+)\]")

# calls that wait for the card (or copy to the host) when recorded in a capture
_HOST_ATTR_CALLS = {"item", "cpu", "tolist", "numpy"}


def _ignores(source: str) -> dict[int, set]:
    """line number -> rule names suppressed on that line."""
    out: dict[int, set] = {}
    for i, line in enumerate(source.splitlines(), 1):
        m = _IGNORE_RE.search(line)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",")}
    return out


def _dotted(node: ast.AST) -> str:
    """'torch.cuda.graph' for that attribute chain, '' for anything else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_graph_capture(item: ast.withitem) -> bool:
    """``torch.cuda.graph(g)``, ``cuda.graph(g)`` or ``graph(g)`` as a
    ``with`` item."""
    expr = item.context_expr
    return (isinstance(expr, ast.Call)
            and _dotted(expr.func) in ("torch.cuda.graph", "cuda.graph", "graph"))


def _check_host_sync(tree, path: str, ignores, emit) -> None:
    for block in ast.walk(tree):
        if not (isinstance(block, (ast.With, ast.AsyncWith))
                and any(_is_graph_capture(i) for i in block.items)):
            continue
        for stmt in block.body:
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Call):
                    continue
                name = _dotted(node.func)
                bad = None
                if name in ("torch.cuda.synchronize", "cuda.synchronize"):
                    bad = f"{name}()"
                elif (isinstance(node.func, ast.Attribute)
                      and node.func.attr in _HOST_ATTR_CALLS and not node.args):
                    bad = f".{node.func.attr}()"
                if bad is None or "no_host_sync_in_graph" in ignores.get(node.lineno, ()):
                    continue
                emit(Violation(
                    "no_host_sync_in_graph", f"{path}:{node.lineno}",
                    f"{bad} inside a torch.cuda.graph capture (line "
                    f"{block.lineno}) syncs with the host, which a capture "
                    f"cannot do (hoist it out of the captured region)"))


def _check_mutable_defaults(tree, path: str, ignores, emit) -> None:
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for default in list(fn.args.defaults) + [
                d for d in fn.args.kw_defaults if d is not None]:
            mutable = isinstance(default, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(default, ast.Call)
                and isinstance(default.func, ast.Name)
                and default.func.id in ("list", "dict", "set"))
            if not mutable:
                continue
            if ("no_mutable_default_arg" in ignores.get(default.lineno, ())
                    or "no_mutable_default_arg" in ignores.get(fn.lineno, ())):
                continue
            emit(Violation(
                "no_mutable_default_arg", f"{path}:{default.lineno}",
                f"mutable default argument in {fn.name!r} (shared across "
                f"calls — default to None and build inside)"))


def _check_bare_asserts(tree, path: str, ignores, emit) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assert):
            continue
        if "no_bare_assert_in_kernels" in ignores.get(node.lineno, ()):
            continue
        emit(Violation(
            "no_bare_assert_in_kernels", f"{path}:{node.lineno}",
            "bare assert in kernels/ (strips under -O, names no shapes) — "
            "raise KernelSpecError via kernels.spec instead"))


def _check_backend_defaults(tree, path: str, ignores, emit) -> None:
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        args = fn.args
        named = args.posonlyargs + args.args + args.kwonlyargs
        defaults = ([None] * (len(args.posonlyargs) + len(args.args)
                              - len(args.defaults))
                    + list(args.defaults) + list(args.kw_defaults))
        for arg, default in zip(named, defaults):
            if (arg.arg == "backend" and isinstance(default, ast.Constant)
                    and default.value == "torch"):
                if "no_plain_backend_default" in ignores.get(fn.lineno, ()):
                    continue
                emit(Violation(
                    "no_plain_backend_default", f"{path}:{fn.lineno}",
                    f"{fn.name!r} defaults backend='torch' — the plain version "
                    f"must be an explicit opt-in, not a kernel path's default"))


def lint_file(path: Path, root: Path, emit: Callable[[Violation], None],
              verbose: Callable[[str], None] = lambda s: None) -> None:
    rel = str(path.relative_to(root))
    source = path.read_text()
    try:
        tree = ast.parse(source, filename=rel)
    except SyntaxError as e:
        emit(Violation("ast_parse", rel, f"does not parse: {e}"))
        return
    ignores = _ignores(source)
    for line, rules in sorted(ignores.items()):
        verbose(f"  suppressed {sorted(rules)} at {rel}:{line}")
    _check_host_sync(tree, rel, ignores, emit)
    _check_mutable_defaults(tree, rel, ignores, emit)
    if "/kernels/" in str(path).replace("\\", "/"):
        _check_bare_asserts(tree, rel, ignores, emit)
        _check_backend_defaults(tree, rel, ignores, emit)


def run_ast_lint(src_root, files: Optional[Iterable] = None,
                 verbose: Callable[[str], None] = lambda s: None) -> list[Violation]:
    """Lint every ``.py`` under ``src_root`` (or an explicit file list)."""
    root = Path(src_root)
    out: list[Violation] = []
    targets = ([Path(f) for f in files] if files is not None
               else sorted(root.rglob("*.py")))
    for path in targets:
        lint_file(path, root if root in path.parents or path == root
                  else path.parent, out.append, verbose)
    return out
