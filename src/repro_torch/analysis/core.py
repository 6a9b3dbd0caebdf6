"""Shared traversal engine of the port's repro-lint.  Counterpart of
``repro.analysis.core``.

One parse of a module produces a :class:`ModuleModel` every rule shares:

  * **Import table** — local names resolved to canonical dotted paths, so
    ``torch.cuda.synchronize`` and ``from torch import cuda as tc;
    tc.synchronize`` both canonicalize to ``torch.cuda.synchronize``
    (rules match on canonical names, never on surface spellings).
  * **Function table** — every ``def``/``lambda`` with its qualname,
    enclosing class/function, and scope-chain name lookup (latest *and*
    shadowed bindings), as the reference's.
  * **Hot-context inference** — the set of function bodies that run every
    step.  The port traces nothing (no ``jit``, no ``torch.compile``, no
    CUDA graph), so where the reference seeds from JAX's tracing
    transforms, the port seeds from its step builders: the closures
    returned by ``make_*`` functions (the reference's own builder
    convention) and the functions defined inside ``build_step_program``.
    Hotness propagates to nested defs and locally-resolvable callees
    (including ``self.method()`` within a class).
  * **Taint** — a conservative source-order walk classifying which local
    names hold tensors inside a hot function (its parameters, results of
    ``torch.*`` calls and methods on tensors), with the host escapes
    (``.shape``/``.dtype``/``.device``/``.size()``/``.numel()``,
    ``len()``, ``isinstance()``) untainted, so rules can tell a host read
    of a *tensor* (a device sync on the card) from one of a Python number.
  * **Suppressions** — ``# repro-lint: disable=T2[,R7]`` on the finding's
    line or on a comment-only line directly above it.

The engine is pure stdlib ``ast`` — no imports of the analyzed code, so
linting never executes (or requires the dependencies of) the target.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Iterator, Optional

# --------------------------------------------------------------------------
# findings
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, addressable for suppression and baselining.

    ``key()`` deliberately excludes the line *number*: baselines match on
    (rule, path, enclosing qualname, stripped line text) so unrelated
    edits above a baselined line don't invalidate the entry."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    context: str          # enclosing qualname, or "<module>"
    line_text: str        # stripped source of the offending line

    def key(self) -> tuple:
        return (self.rule, _posix(self.path), self.context, self.line_text)

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"[{self.context}] {self.message}")


def _posix(path: str) -> str:
    return str(path).replace("\\", "/")


# --------------------------------------------------------------------------
# import-alias resolution
# --------------------------------------------------------------------------


class ImportTable:
    """Maps local names to canonical dotted module/attribute paths."""

    def __init__(self, tree: ast.AST):
        self.names: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.names[a.asname] = a.name
                    else:
                        # ``import torch.nn`` binds the *root* name
                        self.names[a.name.split(".")[0]] = \
                            a.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.names[a.asname or a.name] = \
                        f"{node.module}.{a.name}"

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Canonical dotted path of a Name/Attribute chain, else None."""
        if isinstance(node, ast.Name):
            return self.names.get(node.id, node.id)
        if isinstance(node, ast.Attribute):
            base = self.resolve(node.value)
            if base is None:
                return None
            return f"{base}.{node.attr}"
        return None


# --------------------------------------------------------------------------
# function table
# --------------------------------------------------------------------------

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)

# the function whose nested defs are a step program's bodies
_STEP_ASSEMBLER = "build_step_program"


@dataclasses.dataclass
class Func:
    """One function body and everything rules need to reason about it."""

    node: ast.AST                      # FunctionDef / AsyncFunctionDef / Lambda
    name: str
    qualname: str
    parent: Optional["Func"]           # enclosing function, if nested
    cls: Optional[str]                 # enclosing class name, if a method
    hot: bool = False
    # True when this function is itself a step body (its parameters hold
    # the step's tensors); propagation-hot callees keep False — their
    # arguments may be host values at the call site.
    params_hot: bool = False
    # Per-parameter taint inferred from call sites inside hot code.
    tainted_params: set = dataclasses.field(default_factory=set)

    def params(self) -> list:
        a = self.node.args
        out = [p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)]
        if a.vararg:
            out.append(a.vararg.arg)
        if a.kwarg:
            out.append(a.kwarg.arg)
        return out

    def body(self) -> list:
        b = self.node.body
        return b if isinstance(b, list) else [ast.Expr(b)]  # Lambda

    def own_statements(self) -> Iterator[ast.stmt]:
        """Statements of this function, not descending into nested defs."""
        yield from _iter_own(self.body())

    def own_nodes(self) -> Iterator[ast.AST]:
        """All expression/statement nodes of this function's own body,
        each exactly once, not descending into nested function bodies
        (their nodes belong to the nested :class:`Func`)."""
        for stmt in self.own_statements():
            if isinstance(stmt, _FUNC_NODES):
                # the def statement itself (decorators) is ours
                for d in getattr(stmt, "decorator_list", []):
                    yield from ast.walk(d)
                continue
            yield stmt
            yield from stmt_exprs(stmt)


def _iter_own(body: list) -> Iterator[ast.stmt]:
    for stmt in body:
        yield stmt
        if isinstance(stmt, _FUNC_NODES):
            continue
        yield from _iter_own_children(stmt)


def _iter_own_children(stmt: ast.AST) -> Iterator[ast.stmt]:
    for field in stmt._fields:
        value = getattr(stmt, field, None)
        if isinstance(value, list):
            for item in value:
                if isinstance(item, ast.stmt):
                    yield item
                    if not isinstance(item, _FUNC_NODES):
                        yield from _iter_own_children(item)
                elif isinstance(item, ast.AST):
                    # ExceptHandler / match_case hold statement lists
                    yield from _iter_own_children(item)


def stmt_exprs(stmt: ast.AST) -> Iterator[ast.AST]:
    """Expression(-ish) nodes belonging to this statement only — child
    statements are iterated by their own :meth:`Func.own_statements`
    round, nested function bodies by their own :class:`Func`."""
    for child in ast.iter_child_nodes(stmt):
        if isinstance(child, (ast.stmt,) + _FUNC_NODES):
            continue
        yield from _walk_expr_skip_stmts(child)


def _walk_expr_skip_stmts(node: ast.AST) -> Iterator[ast.AST]:
    yield node
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.stmt,) + _FUNC_NODES):
            continue
        yield from _walk_expr_skip_stmts(child)


def module_statements(tree: ast.Module) -> Iterator[ast.stmt]:
    """The module's own statements (in ``if``/``try`` blocks too), not
    descending into function or class bodies."""
    for stmt in _iter_own(tree.body):
        if not isinstance(stmt, _FUNC_NODES + (ast.ClassDef,)):
            yield stmt


class _FuncCollector(ast.NodeVisitor):
    def __init__(self):
        self.funcs: list[Func] = []
        self.by_node: dict[int, Func] = {}
        # scope key (id of enclosing Func node, or None) -> name -> [Func]
        self.scopes: dict[Optional[int], dict[str, list[Func]]] = {None: {}}
        self.methods: dict[str, dict[str, list[Func]]] = {}
        self._stack: list[str] = []
        self._func_stack: list[Func] = []
        self._cls_stack: list[str] = []

    def _add(self, node, name) -> Func:
        parent = self._func_stack[-1] if self._func_stack else None
        cls = self._cls_stack[-1] if self._cls_stack else None
        qual = ".".join(self._stack + [name]) if self._stack else name
        f = Func(node=node, name=name, qualname=qual, parent=parent,
                 cls=cls if (parent is None or parent.cls == cls) else None)
        self.funcs.append(f)
        self.by_node[id(node)] = f
        key = id(parent.node) if parent else None
        self.scopes.setdefault(key, {}).setdefault(name, []).append(f)
        if f.cls is not None and parent is None:
            self.methods.setdefault(f.cls, {}).setdefault(name, []).append(f)
        return f

    def _visit_func(self, node):
        f = self._add(node, node.name)
        self._stack.append(node.name)
        self._func_stack.append(f)
        self.generic_visit(node)
        self._func_stack.pop()
        self._stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_Lambda(self, node):
        f = self._add(node, "<lambda>")
        self._func_stack.append(f)
        self.generic_visit(node)
        self._func_stack.pop()

    def visit_ClassDef(self, node):
        self._stack.append(node.name)
        self._cls_stack.append(node.name)
        self.generic_visit(node)
        self._cls_stack.pop()
        self._stack.pop()


# --------------------------------------------------------------------------
# module model
# --------------------------------------------------------------------------

_SUPPRESS_RE = re.compile(r"#\s*repro-lint:\s*disable=([A-Za-z0-9_,\s]+)")


class ModuleModel:
    """Everything rules need about one parsed module."""

    def __init__(self, path: str, source: str,
                 is_test: Optional[bool] = None):
        self.path = _posix(path)
        self._is_test = is_test
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.imports = ImportTable(self.tree)
        c = _FuncCollector()
        c.visit(self.tree)
        self.funcs = c.funcs
        self._by_node = c.by_node
        self._scopes = c.scopes
        self._methods = c.methods
        self.suppressions = self._parse_suppressions()
        self._infer_hot()
        self._infer_param_taint()

    # ------------------------------------------------------------- helpers
    @property
    def is_test(self) -> bool:
        if self._is_test is not None:
            return self._is_test
        parts = Path(self.path).parts
        return ("tests" in parts or "test" in parts
                or Path(self.path).name.startswith("test_"))

    @property
    def in_kernels(self) -> bool:
        """A module of a ``kernels`` package (the launch wrappers)."""
        return "kernels" in Path(self.path).parts[:-1]

    def resolve(self, node: ast.AST) -> Optional[str]:
        return self.imports.resolve(node)

    def func_of(self, node: ast.AST) -> Optional[Func]:
        return self._by_node.get(id(node))

    def enclosing_qualname(self, lineno: int) -> str:
        best = None
        for f in self.funcs:
            n = f.node
            end = getattr(n, "end_lineno", n.lineno)
            if n.lineno <= lineno <= end:
                if best is None or n.lineno >= best.node.lineno:
                    best = f
        return best.qualname if best else "<module>"

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        text = (self.lines[line - 1].strip()
                if 0 < line <= len(self.lines) else "")
        return Finding(rule=rule, path=self.path, line=line, col=col,
                       message=message,
                       context=self.enclosing_qualname(line),
                       line_text=text)

    def lookup(self, name: str, scope: Optional[Func]) -> list:
        """All Funcs bound to ``name`` visible from ``scope`` (scope chain
        then module level), every binding so that shadowed redefinitions
        are seeded too."""
        cur = scope
        while cur is not None:
            hits = self._scopes.get(id(cur.node), {}).get(name)
            if hits:
                return hits
            cur = cur.parent
        return self._scopes.get(None, {}).get(name, [])

    def lookup_method(self, cls: str, name: str) -> list:
        return self._methods.get(cls, {}).get(name, [])

    def nested_funcs(self, f: Func) -> list:
        out = []
        for hits in self._scopes.get(id(f.node), {}).values():
            out.extend(hits)
        return out

    def returned_local_funcs(self, f: Func) -> list:
        """Local defs that ``f`` returns by name (builder convention)."""
        out = []
        for stmt in f.own_statements():
            if isinstance(stmt, ast.Return) and isinstance(stmt.value,
                                                           ast.Name):
                out.extend(self.lookup(stmt.value.id, f))
        return out

    def callees(self, f: Func, call: ast.Call) -> list:
        """The locally-resolvable Funcs a call in ``f`` may reach."""
        fn = call.func
        if isinstance(fn, ast.Name):
            return self.lookup(fn.id, f)
        if (isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name)
                and fn.value.id == "self" and f.cls):
            return self.lookup_method(f.cls, fn.attr)
        return []

    # -------------------------------------------------------- suppressions
    def _parse_suppressions(self) -> dict:
        out: dict[int, set] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if m:
                out[i] = {r.strip().upper() for r in m.group(1).split(",")
                          if r.strip()}
        return out

    def suppressed(self, finding: Finding) -> bool:
        line = finding.line
        if finding.rule in self.suppressions.get(line, ()):
            return True
        # a comment-only line directly above also applies
        prev = self.lines[line - 2].strip() if line >= 2 else ""
        return (prev.startswith("#")
                and finding.rule in self.suppressions.get(line - 1, ()))

    # ---------------------------------------------------- hot-context pass
    def _infer_hot(self) -> None:
        seeds: list[Func] = []
        for f in self.funcs:
            if f.name.startswith("make_"):
                # the registry/StepProgram builder convention: a closure a
                # ``make_*`` function returns is called every step
                seeds.extend(self.returned_local_funcs(f))
            elif f.name == _STEP_ASSEMBLER:
                seeds.extend(self.nested_funcs(f))
        for f in seeds:
            f.params_hot = True
        work = list(seeds)
        while work:
            f = work.pop()
            if f.hot:
                continue
            f.hot = True
            work.extend(self.nested_funcs(f))
            for node in f.own_nodes():
                if isinstance(node, ast.Call):
                    work.extend(self.callees(f, node))

    def _infer_param_taint(self) -> None:
        """Flow call-site argument taint into locally-resolvable callees
        (to fixpoint): a hot caller passing a tensor taints exactly the
        receiving parameter."""
        changed = True
        while changed:
            changed = False
            for f in self.funcs:
                if not f.hot:
                    continue
                taint = Taint(self, f)
                for stmt in f.own_statements():
                    for node in stmt_exprs(stmt):
                        if isinstance(node, ast.Call):
                            changed |= self._flow_call(f, node, taint)
                    taint.advance(stmt)

    def _flow_call(self, caller: Func, call: ast.Call,
                   taint: "Taint") -> bool:
        changed = False
        for g in self.callees(caller, call):
            params = [p for p in g.params() if p != "self"]
            flows = [(params[i], a) for i, a in enumerate(call.args)
                     if i < len(params)]
            flows += [(kw.arg, kw.value) for kw in call.keywords
                      if kw.arg in params]
            for name, arg in flows:
                if name not in g.tainted_params and taint.tainted(arg):
                    g.tainted_params.add(name)
                    changed = True
        return changed


# --------------------------------------------------------------------------
# taint: which expressions hold tensors inside a hot function
# --------------------------------------------------------------------------

# attribute reads that give host metadata of a tensor
_STATIC_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "is_cpu",
                 "requires_grad", "layout", "is_meta"}
# tensor methods that give host values without touching the data
_STATIC_METHODS = {"size", "numel", "dim", "element_size", "nelement",
                   "data_ptr", "stride", "is_contiguous",
                   "untyped_storage", "get_device"}
# builtins whose results are host values
_STATIC_CALLS = {"len", "isinstance", "hasattr", "getattr", "type", "range",
                 "enumerate", "zip", "min", "max", "tuple", "list", "dict",
                 "sorted", "str", "repr", "id"}


class Taint:
    """Conservative, source-order taint for one hot function.

    Parameters (minus ``self``) of a step body start tainted; a
    propagation-hot callee starts with its call-site-tainted parameters;
    results of ``torch.*`` calls and of methods on tensors are tainted;
    host metadata escapes.  ``advance(stmt)`` folds a statement's
    assignments into the name set; ``tainted(expr)`` classifies an
    expression.  No fixpoint over loops — under-reports rather than
    over-reports."""

    def __init__(self, model: ModuleModel, func: Func):
        self.model = model
        if func.params_hot:
            self.names = {p for p in func.params() if p != "self"}
        else:
            self.names = set(func.tainted_params) - {"self"}

    def advance(self, stmt: ast.stmt) -> None:
        targets: list = []
        if isinstance(stmt, ast.Assign):
            value, targets = stmt.value, stmt.targets
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            value, targets = stmt.value, [stmt.target]
        elif isinstance(stmt, ast.For):
            value, targets = stmt.iter, [stmt.target]
        else:
            return
        is_tainted = value is not None and self.tainted(value)
        for t in targets:
            for name in target_names(t):
                if is_tainted:
                    self.names.add(name)
                else:
                    self.names.discard(name)

    def tainted(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return False
            return self.tainted(node.value)
        if isinstance(node, ast.Subscript):
            return self.tainted(node.value)
        if isinstance(node, ast.Call):
            return self._call_tainted(node)
        if isinstance(node, ast.BinOp):
            return self.tainted(node.left) or self.tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.tainted(node.operand)
        if isinstance(node, ast.Compare):
            # identity/membership tests are structural (x is None, "k" in d)
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return self.tainted(node.left) or \
                any(self.tainted(c) for c in node.comparators)
        if isinstance(node, ast.BoolOp):
            return any(self.tainted(v) for v in node.values)
        if isinstance(node, ast.IfExp):
            return self.tainted(node.body) or self.tainted(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.tainted(e) for e in node.elts)
        if isinstance(node, ast.Starred):
            return self.tainted(node.value)
        return False

    def _call_tainted(self, node: ast.Call) -> bool:
        target = self.model.resolve(node.func)
        if target in _STATIC_CALLS:
            return False
        if target and target.startswith("torch."):
            return True
        if isinstance(node.func, ast.Attribute):
            if node.func.attr in _STATIC_METHODS:
                return False
            # a method on a tensor (x.float(), x.sum(), ...)
            return self.tainted(node.func.value) or \
                any(self.tainted(a) for a in node.args)
        return any(self.tainted(a) for a in node.args)


def target_names(target: ast.AST) -> Iterator[str]:
    if isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, (ast.Tuple, ast.List)):
        for e in target.elts:
            yield from target_names(e)
    elif isinstance(target, ast.Starred):
        yield from target_names(target.value)


# --------------------------------------------------------------------------
# dotted-path helpers shared by rules
# --------------------------------------------------------------------------


def dotted(node: ast.AST) -> Optional[str]:
    """Surface dotted form of a Name/Attribute chain (``self._pages``),
    used where *identity* of a variable matters, not canonical imports."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return None if base is None else f"{base}.{node.attr}"
    return None


def analyze_module(path: str, source: Optional[str] = None,
                   rules=None, is_test: Optional[bool] = None) -> list:
    """Parse + run rules over one module; returns non-suppressed findings
    (suppressed ones are dropped here, baselining happens in the CLI)."""
    from repro_torch.analysis.rules import ALL_RULES
    if source is None:
        source = Path(path).read_text()
    model = ModuleModel(path, source, is_test=is_test)
    out = []
    for rule in (rules if rules is not None else ALL_RULES):
        for f in rule.check(model):
            if not model.suppressed(f):
                out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out
