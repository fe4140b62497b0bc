"""stdlib-``ast`` lint rules for the port (stands for
``repro/analysis/astlint.py``).

Rules (ids are stable: they key the baseline file and SARIF output):

  print-in-library        warning  a library module of ``src/repro_torch``
                                   calls ``print(...)``: human output belongs
                                   in a CLI (``__main__.py`` modules and
                                   ``launch/report.py`` are exempt) or in
                                   ``obs.events.EventLog``.  The reference's
                                   rule, unchanged.
  tracked-bytecode        error    ``git ls-files`` reports committed
                                   ``.pyc``/``.pyo``/``__pycache__`` entries.
                                   The reference's rule, unchanged.
  port-imports-reference  error    ``import jax`` / ``from jax ...`` or an
                                   import of the reference package ``repro``
                                   inside ``src/repro_torch`` or
                                   ``chip_smoke.py``: the port's own ground
                                   rule (only its tests import both).
  hardcoded-device        warning  a public function whose ``device``
                                   parameter defaults to a device
                                   (``"cpu"``, ``"cuda"``, ``torch.device(
                                   ...)``) rather than ``None``, which
                                   ``default_device`` resolves: it stands
                                   for the reference's ``hardcoded-
                                   interpret`` (an entry point pinned to a
                                   backend whatever the caller runs on).
  mutable-default         error    a parameter defaults to a list, dict or
                                   set literal (or ``list()``, ``dict()``,
                                   ``set()``): one object shared by every
                                   call.  It stands for the reference's
                                   ``static-unhashable-default``.

The reference's ``prng-key-reuse``, ``prng-split-overflow``,
``tracer-python-branch`` and ``jit-mutable-global`` have no counterpart:
the port draws from ``torch.Generator`` objects and tensors handed in (no
keys to reuse or split), runs eagerly (Python control flow on a tensor is
an ordinary host read, not a trace-time branch), and compiles nothing that
could bake in a global.

Inline suppression: ``# repro-lint: allow=<rule>[,<rule>]`` on the flagged
line or on the enclosing ``def`` line, as in the reference.
"""
from __future__ import annotations

import ast
import glob
import os
import re
import subprocess
from typing import List, Optional, Sequence

from repro_torch.analysis.findings import Finding

RULES = {
    "print-in-library": "warning",
    "tracked-bytecode": "error",
    "port-imports-reference": "error",
    "hardcoded-device": "warning",
    "mutable-default": "error",
}

# what the port's gate lints, relative to the repository's root
DEFAULT_PATHS = ("src/repro_torch", "chip_smoke.py", "tests/test_torch_*.py")

_PRINT_EXEMPT_SUFFIXES = ("__main__.py", "launch/report.py")
_PRAGMA_RE = re.compile(r"#\s*repro-lint:\s*allow=([\w,\-]+)")
_REFERENCE_ROOTS = ("jax", "jaxlib", "repro")
_MUTABLE_CALLS = ("list", "dict", "set")


def _is_library(path: str) -> bool:
    p = path.replace(os.sep, "/")
    return ("repro_torch/" in p
            and not p.endswith(_PRINT_EXEMPT_SUFFIXES))


def _is_port(path: str) -> bool:
    p = path.replace(os.sep, "/")
    return "repro_torch/" in p or os.path.basename(p) == "chip_smoke.py"


def _device_default(node: ast.AST) -> bool:
    """A default that names a device: a string, or ``torch.device(...)``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return True
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "device")


def _mutable(node: ast.AST) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set)):
        return True
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in _MUTABLE_CALLS and not node.args)


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, source: str):
        self.path = path
        self.lines = source.splitlines()
        self.findings: List[Finding] = []
        self.library = _is_library(path)
        self.port = _is_port(path)
        self._def_lines: List[int] = []

    def emit(self, rule: str, line: int, message: str):
        f = Finding(rule=rule, severity=RULES[rule], path=self.path,
                    line=line, message=message)
        for ln in [line] + self._def_lines[-1:]:
            if 1 <= ln <= len(self.lines):
                m = _PRAGMA_RE.search(self.lines[ln - 1])
                if m and rule in m.group(1).split(","):
                    f.suppressed, f.suppressed_by = True, "pragma"
        self.findings.append(f)

    # -- functions: defaults ------------------------------------------------

    def visit_FunctionDef(self, node):
        self._def_lines.append(node.lineno)
        self._check_defaults(node)
        self.generic_visit(node)
        self._def_lines.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def _check_defaults(self, node):
        a = node.args
        pos = a.posonlyargs + a.args
        pairs = list(zip(pos[len(pos) - len(a.defaults):], a.defaults))
        pairs += [(k, d) for k, d in zip(a.kwonlyargs, a.kw_defaults)
                  if d is not None]
        for arg, d in pairs:
            if _mutable(d):
                self.emit("mutable-default", d.lineno,
                          f"parameter {arg.arg!r} of {node.name!r} defaults "
                          f"to a mutable {type(d).__name__.lower()}: one "
                          f"object shared by every call")
            if (arg.arg == "device" and not node.name.startswith("_")
                    and _device_default(d)):
                self.emit("hardcoded-device", d.lineno,
                          f"{node.name!r} pins its device to "
                          f"{ast.unparse(d)}; default to None and resolve "
                          f"it with repro_torch.default_device")

    # -- calls and imports ---------------------------------------------------

    def visit_Call(self, node):
        if (self.library and isinstance(node.func, ast.Name)
                and node.func.id == "print"):
            self.emit("print-in-library", node.lineno,
                      "print() in a library module; route output through "
                      "a CLI (__main__.py) or obs.events.EventLog")
        self.generic_visit(node)

    def _check_import(self, node, names):
        if not self.port:
            return
        for name in names:
            if name and name.split(".")[0] in _REFERENCE_ROOTS:
                self.emit("port-imports-reference", node.lineno,
                          f"the port imports {name!r}: it imports nothing "
                          f"of jax or of the reference package")

    def visit_Import(self, node):
        self._check_import(node, [a.name for a in node.names])

    def visit_ImportFrom(self, node):
        if node.level == 0:
            self._check_import(node, [node.module])


def lint_source(path: str, source: str) -> List[Finding]:
    """Lint one file's source text (path is used for reporting only)."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(rule="mutable-default", severity="error", path=path,
                        line=e.lineno or 0,
                        message=f"syntax error: {e.msg}")]
    linter = _Linter(path, source)
    linter.visit(tree)
    return linter.findings


def lint_file(path: str, *, rel_to: Optional[str] = None) -> List[Finding]:
    with open(path, encoding="utf-8") as fh:
        src = fh.read()
    rel = os.path.relpath(path, rel_to) if rel_to else path
    return lint_source(rel, src)


def expand(paths: Sequence[str], root: str = ".") -> List[str]:
    """Every .py file under each path (a file, a directory or a glob),
    relative to ``root``."""
    out: List[str] = []
    for p in paths:
        for hit in sorted(glob.glob(os.path.join(root, p))):
            if os.path.isfile(hit):
                out.append(hit)
                continue
            for d, dirs, files in os.walk(hit):
                dirs[:] = sorted(x for x in dirs if x != "__pycache__")
                out.extend(os.path.join(d, f) for f in sorted(files)
                           if f.endswith(".py"))
    return out


def lint_paths(paths: Sequence[str] = DEFAULT_PATHS,
               root: str = ".") -> List[Finding]:
    out: List[Finding] = []
    for f in expand(paths, root):
        out.extend(lint_file(f, rel_to=root))
    return out


def hygiene_findings(repo_root: str) -> List[Finding]:
    """tracked-bytecode: committed .pyc/.pyo/__pycache__ entries."""
    try:
        res = subprocess.run(
            ["git", "ls-files", "*.pyc", "*.pyo", "**/__pycache__/*"],
            cwd=repo_root, capture_output=True, text=True, check=True)
    except (OSError, subprocess.CalledProcessError):
        return []          # not a git checkout: nothing to check
    return [Finding(rule="tracked-bytecode", severity="error", path=p,
                    line=0, message="bytecode file is tracked by git; "
                                    "`git rm --cached` it (see .gitignore)")
            for p in res.stdout.splitlines() if p.strip()]
