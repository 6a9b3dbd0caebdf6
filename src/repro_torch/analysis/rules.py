"""The port's repro-lint rules: the reference's rules in torch form, and its
framework-neutral ones carried over.  Counterpart of
``repro.analysis.rules``.

Each rule is a stateless object with ``id``, ``title``, ``invariant``
(the guarantee it protects, printed by ``--list-rules``), ``counterpart``
(the reference's rule id) and ``check(model) -> [Finding]``.

| port | reference | what it flags |
|---|---|---|
| —  | R1 recompile-hazard | no counterpart: the port traces nothing (no ``jit``, no ``torch.compile``, no CUDA graph; ``launch/op_analysis.py``), so nothing can retrace |
| T2 | R2 host-sync-in-hot-path | ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``, ``float()``/``int()`` of a tensor and ``torch.cuda.synchronize`` in a step program, an ``on_step_end`` hook, or an engine's ``step``/``run``/``_run_chunk``/``_collect`` |
| T3 | R3 donation-safety | an in-place write to a tensor saved for backward inside a ``torch.autograd.Function`` (the in-place update is torch's form of donation) |
| T4 | R4 pallas-hygiene | in ``kernels/``: a plain ``*_ref`` version reached on a CUDA tensor or from an ``except`` handler in a launch wrapper (the counterpart of ``interpret=True`` left on), a launch extent from ``//`` with no divisibility check and no ceiling; anywhere: ``import triton`` or a kernel build at module level |
| T5 | R5 traced-impurity | the global RNG (torch's default generator without ``generator=``, ``numpy.random.<fn>``, ``random.<fn>``, reseeding) in a hot context: the port checkpoints only explicit generators, so it breaks bitwise resume |
| R6 | R6 spec-drift | carried over (the port's ``run/spec.py`` is a copy of the reference's ``RunSpec``) |
| R7 | R7 exception-hygiene | carried over |

R6 and R7 give the reference's findings, field for field (messages
included).  The rule IDs are stable API — suppression comments and
baseline entries reference them.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional

from repro_torch.analysis.core import (Finding, Func, ModuleModel, Taint,
                                       dotted, module_statements,
                                       stmt_exprs, target_names)

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)

# the per-step hot path of the serving engines (decode loop), as the
# reference's
_ENGINE_HOT = {"step", "run", "_run_chunk", "_collect"}


def hot_contexts(model: ModuleModel) -> Iterator[tuple]:
    """``(func, kind)`` of every hot function: ``"step"`` (a step body or
    a locally-reached callee), ``"hook"`` (an ``on_step_end``) or
    ``"engine"`` (an engine's per-step method) — R2's three contexts."""
    for func in model.funcs:
        if func.hot:
            yield func, "step"
        elif func.name == "on_step_end":
            yield func, "hook"
        elif func.cls and "Engine" in func.cls and func.name in _ENGINE_HOT:
            yield func, "engine"


def _root_chain(node: ast.AST) -> Optional[tuple]:
    """(base name, first attribute) of an expression rooted at a name,
    descending through attribute/subscript/call chains:
    ``ev.metrics.get("x")`` -> ("ev", "metrics")."""
    first = None
    while True:
        if isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, ast.Attribute):
            first = node.attr
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Name):
            return node.id, first
        else:
            return None


def _imported_root(model: ModuleModel, node: ast.AST) -> bool:
    """Whether the Name at the root of an attribute chain is imported
    (so ``random.choice`` is the module's, not a local's)."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return isinstance(node, ast.Name) and node.id in model.imports.names


# --------------------------------------------------------------------------
# T2 — host syncs in hot paths (R2's torch form)
# --------------------------------------------------------------------------

_SYNC_CALLS = {"torch.cuda.synchronize"}
_SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}
_HOST_CASTS = {"float", "int", "numpy.asarray", "numpy.array"}


def _host_value(model: ModuleModel, node: ast.AST) -> bool:
    """Whether an expression is what a host read gave (``x.cpu()``,
    ``x.numpy()``, ``x.tolist()``, ``x.item()``, a ``numpy`` call), or a
    slice of it."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    return (isinstance(fn, ast.Attribute) and fn.attr in _SYNC_METHODS) or \
        (model.resolve(fn) or "").startswith("numpy.")


def _sync_method(node: ast.Call) -> Optional[str]:
    """The name of a host-read method call (``x.item()``, ``x.cpu()``,
    ``x.tolist()``, ``x.numpy()``), else None.  A read of what ``.cpu()``
    returned is on the host already: the sync is the ``.cpu()``."""
    fn = node.func
    if not (isinstance(fn, ast.Attribute) and fn.attr in _SYNC_METHODS
            and not node.args):
        return None
    recv = fn.value
    if isinstance(recv, ast.Call) and isinstance(recv.func, ast.Attribute) \
            and recv.func.attr == "cpu":
        return None
    return fn.attr


class HostSyncInHotPath:
    """Blocking device→host reads in per-step/per-token paths: a step
    program's bodies, ``on_step_end`` hooks and the serving engines'
    decode loop.  One stray ``.item()`` / ``float(tensor)`` waits for the
    card every step.  StepEvent fields are host values by contract (the
    runner reads the step's results in ONE transfer), so coercions of
    ``ev.*`` in hooks are either a sync (bug) or redundant."""

    id = "T2"
    counterpart = "R2"
    title = "host-sync-in-hot-path"
    invariant = ("hot paths make at most one deliberate (suppressed) "
                 "host sync per step/chunk boundary")

    def check(self, model: ModuleModel) -> list:
        out = []
        for func, kind in hot_contexts(model):
            if kind == "step":
                out.extend(self._check_step(model, func))
            else:
                out.extend(self._check_loop(model, func, kind))
        return out

    def _check_step(self, model: ModuleModel, func: Func) -> Iterator:
        taint = Taint(model, func)
        for stmt in func.own_statements():
            for node in stmt_exprs(stmt):
                if not isinstance(node, ast.Call):
                    continue
                target = model.resolve(node.func)
                method = _sync_method(node)
                if target in _SYNC_CALLS:
                    yield model.finding(
                        self.id, node,
                        "torch.cuda.synchronize() inside a step program — "
                        "the host waits for the card every step")
                elif method and taint.tainted(node.func.value):
                    yield model.finding(
                        self.id, node,
                        f".{method}() on a tensor inside a step program — "
                        "blocking device→host read every step")
                elif target in _HOST_CASTS and node.args and \
                        taint.tainted(node.args[0]):
                    yield model.finding(
                        self.id, node,
                        f"{target.split('.')[-1]}() on a tensor inside a "
                        "step program — blocking device→host read every "
                        "step")
            taint.advance(stmt)

    def _check_loop(self, model: ModuleModel, func: Func,
                    kind: str) -> Iterator:
        params = func.params()
        # protocol: on_step_end(self, ctx, ev) — bind by position so
        # renamed parameters are still covered
        ctx_name = params[1] if len(params) > 1 else "ctx"
        ev_name = params[2] if len(params) > 2 else "ev"
        where = "on_step_end" if kind == "hook" else func.qualname

        def device_rooted(node: ast.AST) -> bool:
            root = _root_chain(node)
            if root is None:
                return False
            base, first = root
            return base == ev_name or (
                base == ctx_name and first in ("params", "opt_state"))

        host: set = set()          # names bound to what a host read gave
        for stmt in func.own_statements():
            for node in stmt_exprs(stmt):
                if not isinstance(node, ast.Call):
                    continue
                target = model.resolve(node.func)
                method = _sync_method(node)
                root = _root_chain(node.func.value) if method else None
                if target in _SYNC_CALLS:
                    yield model.finding(
                        self.id, node,
                        f"torch.cuda.synchronize() in {where} — blocking "
                        "host sync on the per-step path")
                elif method and not (root and root[0] in host):
                    yield model.finding(
                        self.id, node,
                        f".{method}() in {where} — blocking per-step host "
                        "read; the loop syncs once per step/chunk boundary "
                        "only: suppress deliberately if this IS that sync")
                elif kind == "hook" and target in _HOST_CASTS and \
                        node.args and device_rooted(node.args[0]):
                    yield model.finding(
                        self.id, node,
                        f"{target.split('.')[-1]}() on `{ev_name}.*`/"
                        f"`{ctx_name}.params`-rooted value in on_step_end "
                        "— StepEvent carries host values (the runner does "
                        "one transfer a step); coercing here is a sync on "
                        "device values and redundant on host ones")
            if isinstance(stmt, ast.Assign):
                names = {n for t in stmt.targets for n in target_names(t)}
                if _host_value(model, stmt.value):
                    host |= names
                else:
                    host -= names


# --------------------------------------------------------------------------
# T3 — in-place writes to tensors saved for backward (R3's torch form)
# --------------------------------------------------------------------------

# in-place methods that write no element
_NOT_WRITES = {"requires_grad_", "share_memory_"}


def _inplace_writes(stmt: ast.stmt) -> Iterator[tuple]:
    """``(node, dotted name)`` of each in-place write ``stmt`` makes to a
    named tensor: ``x.add_(..)``, ``x[..] = ..``, ``x += ..``,
    ``torch.op(.., out=x)``."""
    if isinstance(stmt, ast.AugAssign):
        d = dotted(stmt.target)
        if d:
            yield stmt, d
    if isinstance(stmt, (ast.Assign, ast.AugAssign)):
        targets = (stmt.targets if isinstance(stmt, ast.Assign)
                   else [stmt.target])
        for t in targets:
            if isinstance(t, ast.Subscript) and dotted(t.value):
                yield t, dotted(t.value)
    for node in stmt_exprs(stmt):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr.endswith("_") \
                and not fn.attr.startswith("_") \
                and fn.attr not in _NOT_WRITES and dotted(fn.value):
            yield node, dotted(fn.value)
        for kw in node.keywords:
            if kw.arg == "out" and dotted(kw.value):
                yield node, dotted(kw.value)


class SavedTensorWrite:
    """A tensor handed to ``ctx.save_for_backward`` (or kept on ``ctx``)
    and then written in place — later in ``forward``, or in ``backward``
    after it is read back from ``ctx.saved_tensors`` — gives backward
    values that are not the forward's (autograd's version check raises
    for the first case at best) or corrupts a tensor the caller still
    holds: the torch form of reading a buffer after donating it."""

    id = "T3"
    counterpart = "R3"
    title = "saved-tensor-write"
    invariant = ("no in-place write to a tensor saved for backward in an "
                 "autograd.Function")

    def check(self, model: ModuleModel) -> list:
        out = []
        for node in ast.walk(model.tree):
            if isinstance(node, ast.ClassDef) and any(
                    (model.resolve(b) or "").endswith("autograd.Function")
                    for b in node.bases):
                out.extend(self._check_function(model, node))
        return out

    def _check_function(self, model: ModuleModel,
                        cls: ast.ClassDef) -> Iterator:
        methods = {s.name: model.func_of(s) for s in cls.body
                   if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))}
        attrs: set = set()              # ctx attributes that hold tensors
        fwd = methods.get("forward")
        if fwd is not None:
            yield from self._walk(model, fwd, "forward", attrs)
        bwd = methods.get("backward")
        if bwd is not None:
            yield from self._walk(model, bwd, "backward", attrs)

    def _walk(self, model: ModuleModel, func: Func, which: str,
              attrs: set) -> Iterator:
        params = func.params()
        ctx = params[0] if params else "ctx"
        saved: set = {f"{ctx}.{a}" for a in attrs}
        for stmt in func.own_statements():
            for node, name in _inplace_writes(stmt):
                if name in saved:
                    yield model.finding(
                        self.id, node,
                        f"in-place write to `{name}`, saved for backward, "
                        f"in {which} — backward reads other values than "
                        "forward saved (or the caller's tensor changes); "
                        "write a new tensor")
            # new saves and reads of saved tensors
            for node in stmt_exprs(stmt):
                if isinstance(node, ast.Call) and dotted(node.func) == \
                        f"{ctx}.save_for_backward":
                    saved |= {a.id for a in node.args
                              if isinstance(a, ast.Name)}
            if isinstance(stmt, ast.Assign):
                value = stmt.value
                for t in stmt.targets:
                    d = dotted(t)
                    if d and d.startswith(f"{ctx}.") and \
                            isinstance(value, ast.Name) and \
                            value.id in saved | set(params[1:]):
                        attrs.add(d[len(ctx) + 1:])
                        saved |= {d, value.id}
                    elif dotted(value) == f"{ctx}.saved_tensors" or (
                            dotted(value) in saved):
                        saved |= set(target_names(t))
                    elif isinstance(t, ast.Name):
                        saved.discard(t.id)


# --------------------------------------------------------------------------
# T4 — kernel hygiene (R4's torch form)
# --------------------------------------------------------------------------

_BUILDS = ("kernels.build.load_library", "kernels.build.load_libraries",
           "torch.utils.cpp_extension.load",
           "torch.utils.cpp_extension.load_inline")


def _is_launch(node: ast.AST) -> bool:
    """A kernel launch: a library entry ``lib.<name>_launch(..)`` or a
    Triton launch ``kernel[grid](..)``."""
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    return isinstance(fn, ast.Subscript) or (
        isinstance(fn, ast.Attribute) and fn.attr.endswith("_launch"))


def _launch_extents(call: ast.Call) -> list:
    """The expressions a launch takes its extents from: a Triton launch's
    grid, a library entry's arguments."""
    if isinstance(call.func, ast.Subscript):
        return [call.func.slice]
    return list(call.args)


def _is_ref_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    name = fn.id if isinstance(fn, ast.Name) else (
        fn.attr if isinstance(fn, ast.Attribute) else "")
    return name.endswith("_ref")


def _device_test(model: ModuleModel, test: ast.AST) -> Optional[str]:
    """``"cpu"`` where ``test`` holds only for a tensor off the card (the
    wrappers' ``dry.plain(x)``, ``not x.is_cuda``, ``x.is_cpu``,
    ``x.device.type == "cpu"``), ``"cuda"`` where only for one on it,
    else None."""
    flip = {"cpu": "cuda", "cuda": "cpu", None: None}
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return flip[_device_test(model, test.operand)]
    if isinstance(test, ast.Call):
        target = model.resolve(test.func) or ""
        return "cpu" if target.endswith("dry.plain") else None
    if isinstance(test, ast.Attribute):
        return {"is_cuda": "cuda", "is_cpu": "cpu"}.get(test.attr)
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        states = {_device_test(model, v) for v in test.values} - {None}
        return states.pop() if len(states) == 1 else None
    if isinstance(test, ast.Compare) and len(test.ops) == 1 and \
            dotted(test.left) and dotted(test.left).endswith(".device.type") \
            and isinstance(test.comparators[0], ast.Constant):
        kind = {"cpu": "cpu", "cuda": "cuda"}.get(test.comparators[0].value)
        if isinstance(test.ops[0], ast.Eq):
            return kind
        if isinstance(test.ops[0], ast.NotEq):
            return flip[kind]
    return None


def _plain_floordiv(expr: ast.AST) -> Optional[ast.AST]:
    """A floor division in ``expr`` that is not a ceiling (``-(-a // b)``
    or ``(a + b - 1) // b``), else None."""
    ceilings = set()
    for node in ast.walk(expr):
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub) \
                and isinstance(node.operand, ast.BinOp) \
                and isinstance(node.operand.op, ast.FloorDiv) \
                and isinstance(node.operand.left, ast.UnaryOp) \
                and isinstance(node.operand.left.op, ast.USub):
            ceilings.add(id(node.operand))
        elif isinstance(node, ast.BinOp) and \
                isinstance(node.op, ast.FloorDiv) and \
                isinstance(node.left, ast.BinOp) and \
                isinstance(node.left.op, ast.Sub) and \
                isinstance(node.left.right, ast.Constant) and \
                node.left.right.value == 1:
            ceilings.add(id(node))
    for node in ast.walk(expr):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.FloorDiv) \
                and id(node) not in ceilings:
            return node
    return None


class KernelHygiene:
    """Launch-wrapper hygiene: a CUDA tensor launches the kernel or raises
    — a plain ``*_ref`` version reached on it, or from an ``except``
    handler around the launch, is a fallback that hides the kernel (the
    reference's ``interpret=True`` left on); a launch extent derived by
    floor division with no divisibility check and no ceiling silently
    drops the tail; and ``import triton`` or a kernel build at module
    level breaks importing the package on a machine without them."""

    id = "T4"
    counterpart = "R4"
    title = "kernel-hygiene"
    invariant = ("CUDA tensors reach the kernel, launches are exact "
                 "(divisibility checked or ceiling), nothing is built at "
                 "import")

    def check(self, model: ModuleModel) -> list:
        out = []
        if not model.is_test:
            out.extend(self._check_module_level(model))
        if model.in_kernels:
            for func in model.funcs:
                if any(_is_launch(n) for n in func.own_nodes()):
                    out.extend(self._check_refs(model, func))
                    out.extend(self._check_extents(model, func))
        return out

    def _check_module_level(self, model: ModuleModel) -> Iterator:
        for stmt in module_statements(model.tree):
            names = []
            if isinstance(stmt, ast.Import):
                names = [a.name for a in stmt.names]
            elif isinstance(stmt, ast.ImportFrom):
                names = [stmt.module or ""]
            if any(n == "triton" or n.startswith("triton.") for n in names):
                yield model.finding(
                    self.id, stmt,
                    "`import triton` at module level — a machine without "
                    "triton (the CPU tests) cannot import the module; "
                    "import it inside the function that launches")
            for node in stmt_exprs(stmt):
                if isinstance(node, ast.Call) and (
                        model.resolve(node.func) or "").endswith(_BUILDS):
                    yield model.finding(
                        self.id, node,
                        "kernel build at module level — importing the "
                        "module runs nvcc; build at first launch")

    def _check_refs(self, model: ModuleModel, func: Func) -> Iterator:
        def walk(stmts, state, handler):
            for stmt in stmts:
                if isinstance(stmt, _FUNC_NODES + (ast.ClassDef,)):
                    continue
                for node in stmt_exprs(stmt):
                    if _is_ref_call(node) and (handler or state != "cpu"):
                        where = ("from an except handler" if handler else
                                 "where the tensor may be on the card")
                        yield model.finding(
                            self.id, node,
                            f"plain version reached {where} in a launch "
                            "wrapper — a fallback that hides the kernel; "
                            "a CUDA tensor launches it or raises")
                if isinstance(stmt, ast.If):
                    test = _device_test(model, stmt.test)
                    other = {"cpu": "cuda", "cuda": "cpu"}.get(test)
                    yield from walk(stmt.body, test or state, handler)
                    yield from walk(stmt.orelse, other or state, handler)
                    continue
                for field in ("body", "orelse", "finalbody"):
                    yield from walk(getattr(stmt, field, []), state, handler)
                for h in getattr(stmt, "handlers", []):
                    yield from walk(h.body, state, True)

        yield from walk(func.body(), None, False)

    def _check_extents(self, model: ModuleModel, func: Func) -> Iterator:
        if self._checks_divisibility(func):
            return
        assigned = {}
        for stmt in func.own_statements():
            if isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    for name in target_names(t):
                        assigned[name] = stmt.value
        for node in func.own_nodes():
            if not _is_launch(node):
                continue
            for expr in _launch_extents(node):
                div = _plain_floordiv(expr)
                for n in ast.walk(expr):
                    if div is None and isinstance(n, ast.Name) and \
                            n.id in assigned:
                        div = _plain_floordiv(assigned[n.id])
                if div is not None:
                    yield model.finding(
                        self.id, expr,
                        "launch extent derived by floor division without "
                        "a divisibility check or a ceiling in this "
                        "function — a shape that is not a multiple "
                        "silently drops the tail (check `x % block`, or "
                        "take the ceiling)")

    @staticmethod
    def _checks_divisibility(func: Func) -> bool:
        """An ``assert`` on a ``%``, or an ``if`` on a ``%`` that raises."""
        for stmt in func.own_statements():
            test = stmt.test if isinstance(stmt, (ast.Assert, ast.If)) \
                else None
            if test is None or not any(
                    isinstance(n, ast.BinOp) and isinstance(n.op, ast.Mod)
                    for n in ast.walk(test)):
                continue
            if isinstance(stmt, ast.Assert) or any(
                    isinstance(s, ast.Raise) for s in stmt.body):
                return True
        return False


# --------------------------------------------------------------------------
# T5 — the global RNG in hot paths (R5's torch form)
# --------------------------------------------------------------------------

_TORCH_RNG = {"torch.rand", "torch.randn", "torch.randint", "torch.randperm",
              "torch.rand_like", "torch.randn_like", "torch.randint_like",
              "torch.normal", "torch.bernoulli", "torch.multinomial",
              "torch.poisson"}
_RNG_METHODS = {"uniform_", "normal_", "random_", "bernoulli_",
                "exponential_", "geometric_", "cauchy_", "log_normal_"}
_RESEEDS = {"torch.manual_seed", "torch.seed", "torch.cuda.manual_seed",
            "torch.cuda.manual_seed_all", "numpy.random.seed",
            "random.seed"}
# explicit generators: constructing one touches no global state
_EXPLICIT = {"numpy.random.default_rng", "numpy.random.Generator",
             "numpy.random.RandomState", "numpy.random.SeedSequence",
             "numpy.random.PCG64", "numpy.random.Philox",
             "numpy.random.SFC64", "numpy.random.MT19937",
             "random.Random", "random.SystemRandom", "torch.Generator"}


class GlobalRngInHotPath:
    """The global RNG in per-step code: a draw from torch's default
    generator (no ``generator=``), from ``numpy.random``'s or ``random``'s
    module state, or a reseed of any of them.  Checkpoints hold the
    params, the optimizer state and the explicit generators only, so a
    resumed run draws other values and is no longer bitwise the
    uninterrupted one."""

    id = "T5"
    counterpart = "R5"
    title = "global-rng-in-hot-path"
    invariant = ("hot paths draw only from explicit generators: resume "
                 "stays bitwise")

    def check(self, model: ModuleModel) -> list:
        out = []
        for func, _ in hot_contexts(model):
            for node in func.own_nodes():
                if isinstance(node, ast.Call):
                    why = self._why(model, node)
                    if why:
                        out.append(model.finding(
                            self.id, node,
                            f"{why} in {func.qualname} — the global RNG's "
                            "state is not checkpointed: a resumed run "
                            "draws other values (pass an explicit "
                            "generator)"))
        return out

    @staticmethod
    def _why(model: ModuleModel, node: ast.Call) -> Optional[str]:
        target = model.resolve(node.func) or ""
        has_gen = any(kw.arg == "generator" for kw in node.keywords)
        fn = node.func
        if target in _RESEEDS and _imported_root(model, fn):
            return f"{target}() reseeds a global generator"
        if target in _TORCH_RNG and not has_gen:
            return f"{target}() without generator="
        if isinstance(fn, ast.Attribute) and fn.attr in _RNG_METHODS \
                and not has_gen and not target.startswith("numpy."):
            return f".{fn.attr}() without generator="
        if target.startswith(("numpy.random.", "random.")) and \
                target not in _EXPLICIT and _imported_root(model, fn):
            return f"{target}() draws from the module's global state"
        return None


# --------------------------------------------------------------------------
# R6 — RunSpec serialization drift (carried over)
# --------------------------------------------------------------------------


class SpecDrift:
    """Every RunSpec field must round-trip: nested dataclass fields must
    be re-hydrated in ``from_dict`` and every field must be constructible
    from ``from_cli_args`` — a field added to the dataclass but not the
    (de)serializers silently drops config on spec replay, which breaks
    the spec-addressed artifact contract."""

    id = "R6"
    counterpart = "R6"
    title = "spec-drift"
    invariant = ("RunSpec fields round-trip through to_json/from_json "
                 "and are reachable from the CLI")

    def check(self, model: ModuleModel) -> list:
        spec_cls = None
        for node in ast.walk(model.tree):
            if isinstance(node, ast.ClassDef) and node.name == "RunSpec":
                if self._is_dataclass(model, node):
                    spec_cls = node
                break
        if spec_cls is None:
            return []
        out = []
        dataclass_names = self._module_dataclasses(model)
        fields = self._fields(spec_cls)
        nested = {name: ann for name, ann in fields.items()
                  if self._nested_dataclass(ann, dataclass_names)}

        from_dict = self._method(spec_cls, "from_dict")
        if from_dict is not None:
            mentioned = _str_constants(from_dict)
            for name in nested:
                if name not in mentioned:
                    out.append(model.finding(
                        self.id, self._field_node(spec_cls, name),
                        f"nested field `{name}` is not re-hydrated in "
                        "RunSpec.from_dict — from_json would return a "
                        "plain dict for it (lossy round-trip)"))

        to_dict = self._method(spec_cls, "to_dict")
        if to_dict is not None and not self._uses_asdict(model, to_dict):
            mentioned = _str_constants(to_dict)
            for name in fields:
                if name not in mentioned:
                    out.append(model.finding(
                        self.id, self._field_node(spec_cls, name),
                        f"field `{name}` missing from hand-rolled "
                        "RunSpec.to_dict — to_json drops it"))

        cli = None
        for f in model.funcs:
            if f.name == "from_cli_args" and f.parent is None and \
                    f.cls is None:
                cli = f
        if cli is not None:
            kwargs = self._spec_ctor_kwargs(cli)
            if kwargs is not None:
                for name in fields:
                    if name not in kwargs:
                        out.append(model.finding(
                            self.id, self._field_node(spec_cls, name),
                            f"field `{name}` is never passed by "
                            "from_cli_args — the CLI cannot express it "
                            "(wire a flag or construct it explicitly)"))
        return out

    @staticmethod
    def _is_dataclass(model: ModuleModel, node: ast.ClassDef) -> bool:
        for deco in node.decorator_list:
            target = model.resolve(deco.func if isinstance(deco, ast.Call)
                                   else deco)
            if target and target.endswith("dataclass"):
                return True
        return False

    def _module_dataclasses(self, model: ModuleModel) -> set:
        return {node.name for node in ast.walk(model.tree)
                if isinstance(node, ast.ClassDef)
                and self._is_dataclass(model, node)}

    @staticmethod
    def _fields(cls: ast.ClassDef) -> dict:
        out = {}
        for stmt in cls.body:
            if isinstance(stmt, ast.AnnAssign) and \
                    isinstance(stmt.target, ast.Name):
                ann_names = {n.id for n in ast.walk(stmt.annotation)
                             if isinstance(n, ast.Name)}
                if "ClassVar" in ann_names:
                    continue
                out[stmt.target.id] = ann_names
        return out

    @staticmethod
    def _nested_dataclass(ann_names: set, dataclass_names: set) -> bool:
        if ann_names & dataclass_names:
            return True
        # imported spec/config types follow the *Spec/*Config convention
        return any(n.endswith("Spec") or n.endswith("Config")
                   for n in ann_names)

    @staticmethod
    def _method(cls: ast.ClassDef, name: str):
        for stmt in cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and stmt.name == name:
                return stmt
        return None

    @staticmethod
    def _field_node(cls: ast.ClassDef, name: str) -> ast.AST:
        for stmt in cls.body:
            if isinstance(stmt, ast.AnnAssign) and \
                    isinstance(stmt.target, ast.Name) and \
                    stmt.target.id == name:
                return stmt
        return cls

    @staticmethod
    def _uses_asdict(model: ModuleModel, fn: ast.AST) -> bool:
        return any(isinstance(node, ast.Call)
                   and (model.resolve(node.func) or "").endswith("asdict")
                   for node in ast.walk(fn))

    @staticmethod
    def _spec_ctor_kwargs(cli) -> Optional[set]:
        """Keyword names of the RunSpec(...) construction in the CLI
        builder (the call with the most keywords wins, covering helper
        locals)."""
        best = None
        for node in cli.own_nodes():
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name) and \
                    node.func.id in ("RunSpec", "cls"):
                kwargs = {kw.arg for kw in node.keywords if kw.arg}
                if best is None or len(kwargs) > len(best):
                    best = kwargs
        return best


def _str_constants(node: ast.AST) -> set:
    return {n.value for n in ast.walk(node)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


# --------------------------------------------------------------------------
# R7 — exception hygiene (carried over)
# --------------------------------------------------------------------------

_BROAD_EXC = {"Exception", "BaseException"}


class ExceptionHygiene:
    """Bare ``except:`` and broad handlers that swallow silently: the
    sentinel/retry/rollback machinery classifies failures into
    *transient* (retry), *anomalous* (skip/rollback) and *fatal*
    (propagate) — a handler that catches everything and does nothing
    erases that classification, hides real faults (including
    AnomalyBudgetExceeded, SimulatedKill, preemption signals) and turns
    loud failures into silent corruption.  Catch the narrow type, or
    handle-and-log, or re-raise."""

    id = "R7"
    counterpart = "R7"
    title = "exception-hygiene"
    invariant = ("no bare except; broad Exception handlers must act "
                 "(log/re-raise/recover), never silently swallow")

    def check(self, model: ModuleModel) -> list:
        if model.is_test:
            return []
        out = []
        for node in ast.walk(model.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                out.append(model.finding(
                    self.id, node,
                    "bare `except:` — catches SystemExit/KeyboardInterrupt"
                    "/SimulatedKill too; name the exception type"))
            elif self._catches_broad(node.type) and \
                    self._swallows(node.body):
                out.append(model.finding(
                    self.id, node,
                    "`except Exception` with a no-op body silently "
                    "swallows every failure — catch the narrow type, or "
                    "log/re-raise"))
        return out

    @staticmethod
    def _catches_broad(type_node: ast.AST) -> bool:
        elts = (type_node.elts if isinstance(type_node, ast.Tuple)
                else [type_node])
        return any((isinstance(e, ast.Name) and e.id in _BROAD_EXC)
                   or (isinstance(e, ast.Attribute) and e.attr in _BROAD_EXC)
                   for e in elts)

    @staticmethod
    def _swallows(body: list) -> bool:
        """True when the handler body does nothing observable: only
        ``pass``, ``...``, docstring constants, or ``continue``."""
        return all(isinstance(stmt, (ast.Pass, ast.Continue))
                   or (isinstance(stmt, ast.Expr)
                       and isinstance(stmt.value, ast.Constant))
                   for stmt in body)


ALL_RULES = (HostSyncInHotPath(), SavedTensorWrite(), KernelHygiene(),
             GlobalRngInHotPath(), SpecDrift(), ExceptionHygiene())

RULES_BY_ID = {r.id: r for r in ALL_RULES}
