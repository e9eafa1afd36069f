"""AST-level lint of the port (the mechanical half of the static analysis).

The counterparts of the JAX package's six rules (``repro.analysis.
source_lint``), over ``src/repro_torch``, ``chip_smoke.py`` and
``tests/test_torch_*.py``:

* ``foreign-import`` (JAX: ``compat-door``) — the port stands alone: no
  module of it, and not ``chip_smoke.py``, imports ``jax``, ``jaxlib``,
  ``ml_dtypes`` or the JAX package ``repro``. The tests import both
  packages and are exempt.
* ``kernel-entry-site`` (JAX: ``pallas-call-site``) — the kernels' C
  entry points (the ctypes symbols ``gas_scatter_*`` and ``flash_*``) are
  reached only in ``src/repro_torch/kernels/*/kernel.py``: a symbol is
  reached through its library, so elsewhere no ``ctypes.CDLL`` and no
  reference to a kernel module's bound library (``_load`` / ``_lib`` /
  ``_entries``).
* ``collective-site`` — ``torch.distributed`` collectives are issued only
  in ``core/collectives.py`` (whose wrappers every contract counts) and
  ``launch/mesh.py`` (the group and its barrier).
* ``unticked-dispatch`` — a function outside the kernel modules that
  reaches a raw kernel wrapper (``gas_scatter_banded`` /
  ``gas_scatter_banded_gathered`` / ``gas_scatter_dense``) is private (reached through a ticking public
  wrapper) or ticks ``count_dispatches`` itself.
* ``unknown-marker`` — every ``pytest.mark.<x>`` in the tests is
  registered in ``pyproject.toml``.
* ``f64-literal`` — no ``float64`` literal in the port or
  ``chip_smoke.py`` (``analysis/dtype_flow.py`` catches float64 payloads
  at run time; this catches their seeds). A host-side float64 that a
  numpy oracle or a rounding bound needs carries a justified allow.

A violating line is suppressed with an inline justification::

    x = np.float64(1.0)  # lint: allow(f64-literal): the bound needs it

The justification is required — a bare ``allow()`` does not suppress.
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import re
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

#: every rule this module can emit
RULES = ("foreign-import", "kernel-entry-site", "collective-site",
         "unticked-dispatch", "unknown-marker", "f64-literal")

#: the modules that bind the C entries
KERNEL_MODULES = "src/repro_torch/kernels/*/kernel.py"

#: the modules allowed to issue torch.distributed collectives
COLLECTIVE_SITE_ALLOWLIST = ("src/repro_torch/core/collectives.py",
                             "src/repro_torch/launch/mesh.py")

#: what the port may not import
FOREIGN = ("jax", "jaxlib", "ml_dtypes", "repro")

#: torch.distributed calls that move data between ranks
_COLLECTIVE_CALLS = frozenset({
    "all_gather", "all_gather_into_tensor", "all_gather_single",
    "all_gather_object", "all_to_all", "all_to_all_single", "all_reduce",
    "reduce_scatter", "reduce_scatter_tensor", "reduce_scatter_single",
    "broadcast", "broadcast_object_list", "reduce", "gather", "scatter",
    "send", "recv", "isend", "irecv", "barrier"})

#: a kernel module's handles on its bound C library
_LIBRARY_HANDLES = ("_load", "_lib", "_entries")

#: raw kernel wrappers — referencing these needs a tick or a private caller
_RAW_DISPATCHES = ("gas_scatter_banded", "gas_scatter_banded_gathered",
                   "gas_scatter_dense")

#: pytest's built-in marks (never registered in pyproject)
_BUILTIN_MARKS = frozenset({
    "parametrize", "skip", "skipif", "xfail", "usefixtures",
    "filterwarnings",
})

_F64 = "float64"  # lint: allow(f64-literal): the rule that bans it must name it

_ALLOW_RE = re.compile(
    r"#\s*lint:\s*allow\(([\w\s,-]+)\)\s*[:—-]\s*(\S.*)")


@dataclasses.dataclass(frozen=True)
class Violation:
    path: str          # repo-relative, posix
    line: int          # 1-based
    rule: str          # one of RULES
    msg: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.msg}"


def _dotted(node: ast.AST) -> Optional[str]:
    """'torch.distributed.all_reduce' for an Attribute/Name chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _allowed_lines(source: str) -> Dict[int, Tuple[str, ...]]:
    """line → rules suppressed there (justified ``lint: allow`` comments)."""
    out: Dict[int, Tuple[str, ...]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _ALLOW_RE.search(text)
        if m:
            out[i] = tuple(r.strip() for r in m.group(1).split(","))
    return out


def registered_markers(pyproject_path: Path) -> frozenset:
    """Marker names registered under [tool.pytest.ini_options].markers."""
    import tomllib
    data = tomllib.loads(pyproject_path.read_text())
    markers = (data.get("tool", {}).get("pytest", {})
               .get("ini_options", {}).get("markers", []))
    return frozenset(m.split(":")[0].strip() for m in markers)


class _Linter(ast.NodeVisitor):
    def __init__(self, rel: str, *, markers: frozenset):
        self.rel = rel
        self.markers = markers
        self.violations: List[Violation] = []
        self.func_stack: List[ast.FunctionDef] = []
        # function → raw-dispatch refs [(line, name)]
        self.func_refs: List[List[Tuple[int, str]]] = []
        self.in_tests = rel.startswith("tests/")
        self.is_kernel = fnmatch.fnmatch(rel, KERNEL_MODULES)
        self.collectives_ok = rel in COLLECTIVE_SITE_ALLOWLIST
        # the names torch.distributed goes by here, and the names imported
        # from it
        self.dist_aliases = {"torch.distributed"}
        self.dist_names: set = set()

    def _flag(self, node: ast.AST, rule: str, msg: str):
        self.violations.append(
            Violation(self.rel, getattr(node, "lineno", 0), rule, msg))

    # -- foreign imports and the ctypes library -----------------------------

    def _check_import(self, node: ast.AST, module: str):
        if not self.in_tests and module.split(".")[0] in FOREIGN:
            self._flag(node, "foreign-import",
                       f"import {module} — the port imports neither JAX "
                       f"nor the JAX package")
        if module == "ctypes" and not self.is_kernel:
            for alias in getattr(node, "names", ()):
                if alias.name in ("CDLL", "cdll"):
                    self._flag(node, "kernel-entry-site",
                               "ctypes library loader outside the kernel "
                               "modules")

    def visit_Import(self, node: ast.Import):
        for alias in node.names:
            self._check_import(node, alias.name)
            if alias.name == "torch.distributed" and alias.asname:
                self.dist_aliases.add(alias.asname)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom):
        mod = node.module or ""
        if node.level == 0:
            self._check_import(node, mod)
        if mod == "torch.distributed":
            self.dist_names.update(a.asname or a.name for a in node.names)
        if mod == "torch":
            self.dist_aliases.update(a.asname or a.name for a in node.names
                                     if a.name == "distributed")
        if not self.is_kernel and mod.startswith("repro_torch.kernels"):
            for alias in node.names:
                if alias.name in _LIBRARY_HANDLES:
                    self._flag(node, "kernel-entry-site",
                               f"{alias.name} binds the C entries — reach "
                               f"the kernel through its wrapper")
        self.generic_visit(node)

    # -- kernel entries and dispatch coverage -------------------------------

    def visit_Attribute(self, node: ast.Attribute):
        name = _dotted(node)
        if not self.is_kernel:
            if node.attr in _LIBRARY_HANDLES:
                self._flag(node, "kernel-entry-site",
                           f".{node.attr} reaches a kernel module's bound C "
                           f"library — call the kernel's wrapper")
            if name in ("ctypes.CDLL", "ctypes.cdll"):
                self._flag(node, "kernel-entry-site",
                           "ctypes library loader outside the kernel "
                           "modules")
        self._note_raw_dispatch(node, node.attr)
        if not self.in_tests and node.attr == _F64:
            self._flag(node, "f64-literal",
                       "float64 attribute — the stack is f32 end to end "
                       "(dtype_flow catches the payloads; fix the seed)")
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name):
        self._note_raw_dispatch(node, node.id)
        self.generic_visit(node)

    def _note_raw_dispatch(self, node: ast.AST, leaf: str):
        if self.is_kernel or leaf not in _RAW_DISPATCHES:
            return
        if self.func_stack:
            self.func_refs[-1].append((node.lineno, leaf))
        else:
            self._flag(node, "unticked-dispatch",
                       f"module-level reference to raw kernel entry {leaf}")

    def visit_FunctionDef(self, node: ast.FunctionDef):
        self.func_stack.append(node)
        self.func_refs.append([])
        self.generic_visit(node)
        self.func_stack.pop()
        refs = self.func_refs.pop()
        ticks = any(
            isinstance(n, ast.Call) and (
                (isinstance(n.func, ast.Name) and n.func.id == "_tick")
                or (isinstance(n.func, ast.Attribute)
                    and n.func.attr == "_tick"))
            for n in ast.walk(node))
        if refs and not node.name.startswith("_") and not ticks:
            line, leaf = refs[0]
            self.violations.append(Violation(
                self.rel, line, "unticked-dispatch",
                f"public function {node.name!r} reaches raw kernel entry "
                f"{leaf} without a count_dispatches tick — tick it or make "
                f"it a private impl behind a ticked wrapper"))

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Call(self, node: ast.Call):
        name = _dotted(node.func)
        if name and not self.in_tests and not self.collectives_ok:
            base, _, leaf = name.rpartition(".")
            dist_call = (base in self.dist_aliases if base
                         else leaf in self.dist_names)
            if dist_call and leaf in _COLLECTIVE_CALLS:
                self._flag(node, "collective-site",
                           f"collective {leaf}() outside "
                           f"{COLLECTIVE_SITE_ALLOWLIST} — every collective "
                           f"goes through core/collectives.py, which the "
                           f"contracts count")
        self.generic_visit(node)

    # -- marker registration and f64 literals -------------------------------

    def visit_Module(self, node: ast.Module):
        self.generic_visit(node)
        if self.in_tests:
            for n in ast.walk(node):
                name = _dotted(n) if isinstance(n, ast.Attribute) else None
                if name and name.startswith("pytest.mark."):
                    mark = name.split(".")[2]
                    if mark not in self.markers and \
                            mark not in _BUILTIN_MARKS:
                        self._flag(n, "unknown-marker",
                                   f"pytest.mark.{mark} is not registered "
                                   f"in [tool.pytest.ini_options].markers")

    def visit_Constant(self, node: ast.Constant):
        if not self.in_tests and node.value == _F64:
            self._flag(node, "f64-literal",
                       f"{node.value!r} literal — the stack is f32; a "
                       f"host-side float64 needs a justified allow")
        self.generic_visit(node)


def lint_file(path: Path, root: Path, *,
              markers: Optional[frozenset] = None) -> List[Violation]:
    """Lint one file; ``root`` anchors the repo-relative path the role rules
    key on. ``markers``: registered pytest markers (parsed from
    ``root/pyproject.toml`` when omitted)."""
    rel = path.resolve().relative_to(root.resolve()).as_posix()
    if markers is None:
        markers = registered_markers(root / "pyproject.toml")
    source = path.read_text()
    linter = _Linter(rel, markers=markers)
    linter.visit(ast.parse(source, filename=str(path)))
    allowed = _allowed_lines(source)
    return [v for v in linter.violations
            if v.rule not in allowed.get(v.line, ())]


def repo_files(root: Path) -> List[Path]:
    """The files the port's lint covers."""
    root = root.resolve()
    files = sorted((root / "src" / "repro_torch").rglob("*.py"))
    if (root / "chip_smoke.py").exists():
        files.append(root / "chip_smoke.py")
    return files + sorted((root / "tests").glob("test_torch_*.py"))


def lint_repo(root: Path) -> List[Violation]:
    """Lint ``src/repro_torch``, ``chip_smoke.py`` and
    ``tests/test_torch_*.py`` under ``root``."""
    markers = registered_markers(root / "pyproject.toml")
    out: List[Violation] = []
    for path in repo_files(root):
        out.extend(lint_file(path, root, markers=markers))
    return out


def main(argv: Sequence[str] = ()) -> int:
    root = Path(argv[0]) if argv else Path.cwd()
    vs = lint_repo(root)
    for v in vs:
        print(v, file=sys.stderr)
    return 1 if vs else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
