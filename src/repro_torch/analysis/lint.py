# Copy of src/repro/analysis/lint.py; only this line differs (tests/test_torch_isolation.py checks it).
"""DSAN custom lint pass — ``python -m repro.analysis.lint [paths]``.

AST-based rules for the failure modes this codebase has actually
shipped (see CHANGES.md review rounds), which generic linters cannot
know about:

* **DSAN001** — mutation of a memoized ``window`` deque
  (``append``/``pop``/``clear``/...) in a function that never
  invalidates (``.invalidate()``/``.observe()`` call or an assignment
  to ``_value``/``_total``). Stale MRET memos silently corrupt Eq. 11/12
  admission.
* **DSAN002** — an inline ``Task(...)``/``Job(...)``/
  ``StageInstance(...)`` constructed directly as a dict subscript key or
  ``in``-test operand. These are ``eq=False`` identity dataclasses: a
  fresh instance never matches, the lookup is dead code.
* **DSAN003** — ``==``/``!=`` between time/utilization quantities
  (``*_ms``, ``util*``, ``*mret*``, ``*deadline*``, ``backlog*``,
  ``eta``...). Derived floats want tolerances; exact stamp identity is
  legal but must be declared with ``# dsan: ignore[DSAN003]``.
* **DSAN004** — wall-clock reads (``time.time``/``datetime.now``/...)
  inside deterministic sim paths (``core/``, ``cluster/``,
  ``runtime/engine_core.py``). Virtual time comes from the backend;
  wall-clock there breaks replay and the golden fixtures.
* **DSAN005** — bare ``.remove()`` on an identity-semantic collection
  (``tasks``/``jobs``). ``list.remove`` compares by value; with
  ``eq=False`` elements it happens to degrade to a linear identity
  scan, but the intent must be declared (``# dsan: ignore[DSAN005]``)
  or an O(1) identity container used instead.
* **DSAN006** — a call through an optional hook attribute
  (``self._sanitizer.…(...)`` / ``self._chaos.…(...)``) that no
  enclosing ``is not None`` check guards. The twin-path zero-overhead
  contract keeps these hooks ``None`` unless opted in; an unguarded
  call is an AttributeError waiting for the default path.
* **DSAN007** — an RNG draw from a non-chaos stream inside
  ``repro/chaos/`` code (``np.random.*`` globals, or a ``*rng``
  attribute not owned by ``self``). Chaos must draw only from its own
  seeded ``self.rng`` / ``self.io_rng`` streams — borrowing the sim
  stream breaks the chaos-off bit-identical twin path.

Suppression: ``# dsan: ignore`` (all rules) or
``# dsan: ignore[DSAN003, DSAN005]`` on the offending line.

When ruff / mypy are importable the pass chains them (CI installs
both; the pinned dev container may not have them — they are then
skipped with a note, not an error).
"""
from __future__ import annotations

import argparse
import ast
import importlib.util
import os
import re
import subprocess
import sys
from typing import Iterable, List, NamedTuple, Optional, Set


class Finding(NamedTuple):
    path: str
    line: int
    col: int
    rule: str
    message: str

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col + 1}: "
                f"{self.rule} {self.message}")


_SUPPRESS = re.compile(r"#\s*dsan:\s*ignore(?:\[([A-Za-z0-9, ]+)\])?")

# names that denote time/utilization quantities (DSAN003)
_TIME_NAME = re.compile(
    r"(_ms$|^now$|^eta$|util|mret|deadline|backlog)", re.IGNORECASE)

# deque mutators that invalidate a sliding-window memo (DSAN001)
_WINDOW_MUTATORS = frozenset((
    "append", "appendleft", "extend", "extendleft", "insert",
    "pop", "popleft", "remove", "clear"))

# identity-semantic (eq=False) dataclass constructors (DSAN002)
_IDENTITY_CLASSES = frozenset(("Task", "Job", "StageInstance"))

# identity-semantic collection names (DSAN005)
_IDENTITY_COLLECTIONS = frozenset(("tasks", "jobs"))

# wall-clock calls (DSAN004): attribute form and from-import form
_WALL_CLOCK_ATTRS = {
    "time": frozenset(("time", "monotonic", "perf_counter",
                       "process_time", "time_ns", "monotonic_ns",
                       "perf_counter_ns", "process_time_ns")),
    "datetime": frozenset(("now", "utcnow", "today")),
}
_WALL_CLOCK_NAMES = frozenset(("monotonic", "perf_counter",
                               "process_time"))

# paths whose code must be wall-clock-free (virtual time only)
_DETERMINISTIC = re.compile(
    r"(^|[/\\])(core|cluster)[/\\]|[/\\]runtime[/\\]engine_core\.py$")

# optional hook attributes gated by the twin-path contract (DSAN006)
_HOOK_ATTRS = frozenset(("_sanitizer", "_chaos"))

# chaos code must draw from its own seeded streams (DSAN007)
_CHAOS_PATH = re.compile(r"(^|[/\\])chaos[/\\]")
_RNG_DRAWS = frozenset((
    "random", "normal", "uniform", "integers", "choice",
    "standard_normal", "lognormal", "exponential", "poisson",
    "shuffle", "permutation"))


def _name_of(node: ast.AST) -> Optional[str]:
    """Best-effort identifier for a comparison operand / receiver."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Subscript):
        sl = node.slice
        if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
            return sl.value
        return _name_of(node.value)
    if isinstance(node, ast.Call):
        return _name_of(node.func)
    return None


def _suppressed(lines: List[str], lineno: int, rule: str) -> bool:
    """Suppression on the flagged line, or on a pure-comment line
    directly above it (for lines with no room left)."""
    if not 1 <= lineno <= len(lines):
        return False
    candidates = [lines[lineno - 1]]
    if lineno >= 2 and lines[lineno - 2].lstrip().startswith("#"):
        candidates.append(lines[lineno - 2])
    for text in candidates:
        m = _SUPPRESS.search(text)
        if m:
            if m.group(1) is None:
                return True
            if rule in {r.strip().upper() for r in m.group(1).split(",")}:
                return True
    return False


class _Checker(ast.NodeVisitor):
    def __init__(self, path: str, lines: List[str]):
        self.path = path
        self.lines = lines
        self.findings: List[Finding] = []
        self.deterministic = bool(_DETERMINISTIC.search(path))
        self.chaos_path = bool(_CHAOS_PATH.search(path))

    def _flag(self, node: ast.AST, rule: str, message: str) -> None:
        if not _suppressed(self.lines, node.lineno, rule):
            self.findings.append(Finding(
                self.path, node.lineno, node.col_offset, rule, message))

    # ---- DSAN001: window mutation without invalidation ------------------
    def _check_memo_mutation(self, fn: ast.AST) -> None:
        mutations: List[ast.Call] = []
        invalidates = False
        for node in ast.walk(fn):
            if node is not fn and isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue       # nested defs are their own scope
            if isinstance(node, ast.Call):
                f = node.func
                if (isinstance(f, ast.Attribute)
                        and f.attr in _WINDOW_MUTATORS
                        and isinstance(f.value, ast.Attribute)
                        and f.value.attr == "window"):
                    mutations.append(node)
                elif (isinstance(f, ast.Attribute)
                      and f.attr in ("invalidate", "observe")):
                    invalidates = True
            elif isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if (isinstance(tgt, ast.Attribute)
                            and tgt.attr in ("_value", "_total")):
                        invalidates = True
        if not invalidates:
            for call in mutations:
                self._flag(
                    call, "DSAN001",
                    "mutates a memoized '.window' without invalidating "
                    "(call .invalidate()/.observe() or reset "
                    "_value/_total in the same function)")

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._check_memo_mutation(node)
        self._check_hook_guards(node)
        self.generic_visit(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._check_memo_mutation(node)
        self._check_hook_guards(node)
        self.generic_visit(node)

    # ---- DSAN006: unguarded optional-hook calls -------------------------
    @staticmethod
    def _hook_in_chain(node: ast.AST) -> Optional[str]:
        """Hook attr name when an attribute chain passes through
        ``<recv>._sanitizer`` / ``<recv>._chaos``."""
        while isinstance(node, ast.Attribute):
            if node.attr in _HOOK_ATTRS:
                return node.attr
            node = node.value
        return None

    def _hook_guards(self, test: ast.AST) -> tuple:
        """(hooks proven non-None when ``test`` is true, when false)."""
        pos: Set[str] = set()
        neg: Set[str] = set()
        if isinstance(test, ast.Compare) and len(test.ops) == 1:
            name = (test.left.attr
                    if isinstance(test.left, ast.Attribute)
                    and test.left.attr in _HOOK_ATTRS else None)
            comp = test.comparators[0]
            if (name and isinstance(comp, ast.Constant)
                    and comp.value is None):
                if isinstance(test.ops[0], ast.IsNot):
                    pos.add(name)
                elif isinstance(test.ops[0], ast.Is):
                    neg.add(name)
        elif isinstance(test, ast.Attribute) and test.attr in _HOOK_ATTRS:
            pos.add(test.attr)      # truthiness guard: `if self._chaos:`
        elif isinstance(test, ast.BoolOp):
            if isinstance(test.op, ast.And):
                for v in test.values:
                    p, _ = self._hook_guards(v)
                    pos |= p
            else:
                for v in test.values:
                    _, n = self._hook_guards(v)
                    neg |= n
        elif isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            p, n = self._hook_guards(test.operand)
            return n, p
        return pos, neg

    @staticmethod
    def _terminates(stmts: List[ast.stmt]) -> bool:
        return bool(stmts) and isinstance(
            stmts[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break))

    def _check_hook_guards(self, fn: ast.AST) -> None:
        self._scan_hook_stmts(fn.body, set())

    def _scan_hook_stmts(self, stmts: List[ast.stmt],
                         guarded: Set[str]) -> None:
        guarded = set(guarded)
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue            # own scope, scanned separately
            if isinstance(st, ast.If):
                pos, neg = self._hook_guards(st.test)
                self._scan_hook_expr(st.test, guarded)
                self._scan_hook_stmts(st.body, guarded | pos)
                self._scan_hook_stmts(st.orelse, guarded | neg)
                # `if hook is None: return` proves the tail non-None
                if self._terminates(st.body):
                    guarded |= neg
                if st.orelse and self._terminates(st.orelse):
                    guarded |= pos
                continue
            if isinstance(st, ast.While):
                pos, _ = self._hook_guards(st.test)
                self._scan_hook_expr(st.test, guarded)
                self._scan_hook_stmts(st.body, guarded | pos)
                self._scan_hook_stmts(st.orelse, guarded)
                continue
            if isinstance(st, (ast.For, ast.AsyncFor)):
                self._scan_hook_expr(st.iter, guarded)
                self._scan_hook_stmts(st.body, guarded)
                self._scan_hook_stmts(st.orelse, guarded)
                continue
            if isinstance(st, (ast.With, ast.AsyncWith)):
                for item in st.items:
                    self._scan_hook_expr(item.context_expr, guarded)
                self._scan_hook_stmts(st.body, guarded)
                continue
            if isinstance(st, ast.Try):
                for blk in (st.body, st.orelse, st.finalbody):
                    self._scan_hook_stmts(blk, guarded)
                for h in st.handlers:
                    self._scan_hook_stmts(h.body, guarded)
                continue
            if isinstance(st, ast.Assign):
                for tgt in st.targets:
                    if (isinstance(tgt, ast.Attribute)
                            and tgt.attr in _HOOK_ATTRS):
                        guarded -= {tgt.attr}   # may have been rebound
                self._scan_hook_expr(st.value, guarded)
                continue
            self._scan_hook_expr(st, guarded)

    def _scan_hook_expr(self, node: ast.AST, guarded: Set[str]) -> None:
        if isinstance(node, ast.IfExp):
            pos, neg = self._hook_guards(node.test)
            self._scan_hook_expr(node.test, guarded)
            self._scan_hook_expr(node.body, guarded | pos)
            self._scan_hook_expr(node.orelse, guarded | neg)
            return
        if isinstance(node, ast.BoolOp) and isinstance(node.op, ast.And):
            acc = set(guarded)      # short-circuit: later operands are
            for v in node.values:   # guarded by earlier non-None tests
                self._scan_hook_expr(v, acc)
                p, _ = self._hook_guards(v)
                acc |= p
            return
        if isinstance(node, ast.Call):
            hook = self._hook_in_chain(node.func)
            if hook and hook not in guarded:
                self._flag(
                    node, "DSAN006",
                    f"call through optional hook '{hook}' without an "
                    f"`is not None` guard — the twin-path contract keeps "
                    f"it None unless opted in")
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            self._scan_hook_expr(child, guarded)

    # ---- DSAN002: identity dataclass used as value key ------------------
    @staticmethod
    def _is_identity_ctor(node: ast.AST) -> bool:
        return (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id in _IDENTITY_CLASSES)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        if self._is_identity_ctor(node.slice):
            self._flag(
                node, "DSAN002",
                f"fresh {node.slice.func.id}(...) as a subscript key — "
                f"eq=False dataclasses hash by identity, a new instance "
                f"never matches an existing entry")
        self.generic_visit(node)

    # ---- DSAN002 (in/not-in) + DSAN003 (float == on time) ---------------
    def visit_Compare(self, node: ast.Compare) -> None:
        operands = [node.left] + list(node.comparators)
        for op, right in zip(node.ops, node.comparators):
            if isinstance(op, (ast.In, ast.NotIn)):
                if self._is_identity_ctor(node.left):
                    self._flag(
                        node, "DSAN002",
                        f"fresh {node.left.func.id}(...) in a membership "
                        f"test — eq=False dataclasses compare by "
                        f"identity, this is always False")
            elif isinstance(op, (ast.Eq, ast.NotEq)):
                left = operands[operands.index(right) - 1]
                self._check_time_eq(node, left, right)
        self.generic_visit(node)

    def _check_time_eq(self, node: ast.Compare, left: ast.AST,
                       right: ast.AST) -> None:
        for a, b in ((left, right), (right, left)):
            name = _name_of(a)
            if name is None or not _TIME_NAME.search(name):
                continue
            # comparing against None/str/bool is state inspection, not
            # float arithmetic
            if isinstance(b, ast.Constant) and (
                    b.value is None or isinstance(b.value, (str, bool))):
                return
            self._flag(
                node, "DSAN003",
                f"exact ==/!= on time/utilization quantity '{name}' — "
                f"derived floats need a tolerance; if this is stamp "
                f"identity, declare it with '# dsan: ignore[DSAN003]'")
            return

    # ---- DSAN004: wall clock in deterministic paths ---------------------
    def visit_Call(self, node: ast.Call) -> None:
        if self.deterministic:
            f = node.func
            if isinstance(f, ast.Attribute):
                base = _name_of(f.value)
                if (base in _WALL_CLOCK_ATTRS
                        and f.attr in _WALL_CLOCK_ATTRS[base]):
                    self._flag(
                        node, "DSAN004",
                        f"wall-clock read {base}.{f.attr}() in a "
                        f"deterministic sim path — use the backend's "
                        f"virtual clock (now_ms)")
            elif (isinstance(f, ast.Name)
                  and f.id in _WALL_CLOCK_NAMES):
                self._flag(
                    node, "DSAN004",
                    f"wall-clock read {f.id}() in a deterministic sim "
                    f"path — use the backend's virtual clock (now_ms)")
        self._check_chaos_rng(node)
        self.generic_visit(node)

    # ---- DSAN007: foreign RNG stream in chaos code ----------------------
    def _check_chaos_rng(self, node: ast.Call) -> None:
        if not self.chaos_path:
            return
        f = node.func
        if not isinstance(f, ast.Attribute) or f.attr not in _RNG_DRAWS:
            return
        recv = f.value
        if (isinstance(recv, ast.Attribute) and recv.attr == "random"
                and isinstance(recv.value, ast.Name)
                and recv.value.id in ("np", "numpy")):
            self._flag(
                node, "DSAN007",
                f"np.random.{f.attr}() draws from the global stream "
                f"inside chaos code — use the plan's seeded self.rng / "
                f"self.io_rng")
        elif (isinstance(recv, ast.Attribute) and recv.attr.endswith("rng")
              and not (isinstance(recv.value, ast.Name)
                       and recv.value.id == "self")):
            self._flag(
                node, "DSAN007",
                f"RNG draw from foreign stream '{recv.attr}' inside "
                f"chaos code — chaos must stay on its own seeded "
                f"self.rng / self.io_rng (chaos-off twin paths are "
                f"bit-identical only if no shared stream is consumed)")

    # ---- DSAN005: bare .remove on identity collections ------------------
    def visit_Expr(self, node: ast.Expr) -> None:
        call = node.value
        if (isinstance(call, ast.Call)
                and isinstance(call.func, ast.Attribute)
                and call.func.attr == "remove"):
            recv = _name_of(call.func.value)
            if recv in _IDENTITY_COLLECTIONS:
                self._flag(
                    node, "DSAN005",
                    f"bare .remove() on identity-semantic collection "
                    f"'{recv}' — value comparison on eq=False elements; "
                    f"use an identity container or declare with "
                    f"'# dsan: ignore[DSAN005]'")
        self.generic_visit(node)


def check_source(source: str, path: str = "<string>") -> List[Finding]:
    """Lint one source string; the unit under test for rule tests."""
    tree = ast.parse(source, filename=path)
    checker = _Checker(path, source.splitlines())
    checker.visit(tree)
    return sorted(checker.findings)


def check_file(path: str) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as f:
        return check_source(f.read(), path)


def iter_py_files(paths: Iterable[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                for name in sorted(files):
                    if name.endswith(".py"):
                        yield os.path.join(root, name)


def _run_tool(module: str, argv: List[str]) -> int:
    """Chain a generic tool when importable; skip (rc 0) when absent."""
    if importlib.util.find_spec(module) is None:
        print(f"dsan: {module} not installed here — skipped "
              f"(CI runs it)")
        return 0
    proc = subprocess.run([sys.executable, "-m", module] + argv)
    return proc.returncode


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro.analysis.lint",
        description="DSAN repo-specific lint pass (+ ruff/mypy chain)")
    ap.add_argument("paths", nargs="*", default=["src"],
                    help="files or directories to lint (default: src)")
    ap.add_argument("--no-tools", action="store_true",
                    help="run only the DSAN rules, skip ruff/mypy")
    args = ap.parse_args(argv)

    findings: List[Finding] = []
    seen: Set[str] = set()
    for path in iter_py_files(args.paths):
        real = os.path.realpath(path)
        if real in seen:
            continue
        seen.add(real)
        try:
            findings.extend(check_file(path))
        except SyntaxError as e:
            findings.append(Finding(path, e.lineno or 0, 0, "DSAN000",
                                    f"syntax error: {e.msg}"))
    for f in sorted(findings):
        print(f.render())
    rc = 1 if findings else 0
    print(f"dsan: {len(findings)} finding(s) over {len(seen)} file(s)")

    if not args.no_tools:
        rc = max(rc, _run_tool("ruff", ["check"] + list(args.paths)))
        # no path args: pyproject's [tool.mypy] files= governs scope
        rc = max(rc, _run_tool("mypy", []))
    return rc


if __name__ == "__main__":
    sys.exit(main())
