"""Cost analysis of a traced step, op by op.  Counterpart of
``repro.launch.hlo_analysis``.

The reference parses the HLO XLA compiled and multiplies each loop body's
cost by its trip count.  PyTorch runs eagerly, so there is no program text:
:class:`OpTrace` is a ``TorchDispatchMode`` that sees every aten op the step
dispatches, each layer's own, so no loop can hide one.  Run on the meta
device (``launch/dryrun.py``), the trace allocates nothing and touches no
card.  The cost model is the reference's (``hlo_analysis.py``, per
instruction), with each aten op mapped onto the HLO opcode XLA would give
it (:data:`HLO_OF`):

  * dot (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``matmul``):
    2 · numel(result) · K, K the first operand's contracting dim;
  * convolution: 2 · numel(result) · max(numel(kernel) // result's last
    dim, 1), the reference's approximation;
  * an elementwise, ``reduce`` or ``scatter`` op: 1 FLOP a result element;
  * a transcendental op: 1 transcendental and 1 FLOP a result element;
  * bytes: the operands plus the result of every op, views excepted;
  * free: views, ``detach``, metadata ops and allocations (``empty``), as
    the reference's ``_FREE_OPS``;
  * a kernel launch (``kernels/dry.py``): the FLOPs and bytes it records;
  * a collective (``sharding/collectives.py``'s log): its operand and
    result bytes, and its wire bytes apart, by kind.

Dot FLOPs, the other FLOPs and bytes are kept apart (``dot_flops``,
``flops``, ``bytes``).

The trace also follows the bytes alive on its device: each op's outputs'
storages are added when they first appear and dropped when freed (a weak
reference on the untyped storage), and the peak is kept, the counterpart
of ``memory_analysis()``.  Storages alive before the trace (the params,
the optimizer state, the batch) are adopted with :meth:`OpTrace.adopt`.

An op that needs a tensor's value (``.item()``, ``.tolist()``,
``bool(t)``, ``nonzero``, a Python branch on a tensor) cannot run on the
meta device: the trace raises :class:`DryTraceError`, naming the op and
the line of the port that called it, and never skips the op.

:meth:`OpTrace.records` aggregates the trace as ``(op, input shapes and
dtypes, output shapes and dtypes, count)`` rows, which :func:`cost_of`
reads back (``launch/reanalyze.py``).
"""
from __future__ import annotations

import collections
import math
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

Tensor = torch.Tensor

# The reference's tables (hlo_analysis.py), by HLO name
_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16, "s4": 1, "u4": 1,
}
_ELEMENTWISE_FLOP_OPS = {
    "add", "subtract", "multiply", "divide", "maximum", "minimum", "abs",
    "negate", "compare", "select", "and", "or", "xor", "clamp",
    "floor", "ceil", "round-nearest-afz", "sign", "remainder",
}
_TRANSCENDENTAL_OPS = {"exponential", "log", "rsqrt", "sqrt", "tanh",
                       "logistic", "power", "sine", "cosine",
                       "exponential-minus-one", "log-plus-one", "erf"}
COLLECTIVE_KINDS = ("all_gather", "all_reduce", "reduce_scatter")

# torch dtype name -> HLO name
HLO_DTYPE = {"float64": "f64", "float32": "f32", "bfloat16": "bf16",
             "float16": "f16", "float8_e4m3fn": "f8e4m3fn",
             "float8_e5m2": "f8e5m2", "int64": "s64", "uint64": "u64",
             "int32": "s32", "uint32": "u32", "int16": "s16",
             "uint16": "u16", "int8": "s8", "uint8": "u8", "bool": "pred",
             "complex64": "c64", "complex128": "c128"}


def _hlo_map() -> dict:
    out = {}
    for hlo, names in {
        "dot": ("mm", "bmm", "addmm", "baddbmm", "matmul", "mv", "dot"),
        "convolution": ("convolution", "_convolution"),
        "add": ("add", "add_", "sum_to_size"),
        "subtract": ("sub", "sub_", "rsub"),
        "multiply": ("mul", "mul_", "addcmul", "addcmul_", "addcdiv",
                     "addcdiv_", "lerp", "lerp_", "silu_backward",
                     "gelu_backward", "sigmoid_backward", "tanh_backward",
                     "threshold_backward", "_softmax_backward_data",
                     "_log_softmax_backward_data"),
        "divide": ("div", "div_", "reciprocal", "reciprocal_"),
        "maximum": ("maximum", "relu", "relu_"),
        "minimum": ("minimum",),
        "clamp": ("clamp", "clamp_", "clamp_min", "clamp_min_",
                  "clamp_max", "clamp_max_"),
        "abs": ("abs", "abs_"),
        "negate": ("neg", "neg_"),
        "compare": ("eq", "ne", "lt", "le", "gt", "ge", "isinf", "isnan",
                    "isfinite"),
        "select": ("where", "masked_fill", "masked_fill_", "tril", "triu",
                   "tril_", "triu_"),
        "and": ("logical_and", "bitwise_and", "logical_not",
                "bitwise_not"),
        "or": ("logical_or", "bitwise_or"),
        "xor": ("logical_xor", "bitwise_xor"),
        "floor": ("floor", "floor_divide"),
        "ceil": ("ceil",),
        "round-nearest-afz": ("round",),
        "sign": ("sign", "sgn"),
        "remainder": ("remainder", "fmod"),
        "exponential": ("exp", "exp_", "exp2", "_softmax",
                        "_log_softmax"),
        "log": ("log", "log_", "log2"),
        "rsqrt": ("rsqrt", "rsqrt_"),
        "sqrt": ("sqrt", "sqrt_"),
        "tanh": ("tanh", "tanh_"),
        "logistic": ("sigmoid", "sigmoid_", "silu", "silu_"),
        "power": ("pow", "pow_"),
        "sine": ("sin",),
        "cosine": ("cos",),
        "exponential-minus-one": ("expm1",),
        "log-plus-one": ("log1p",),
        "erf": ("erf", "gelu"),
        "reduce": ("sum", "mean", "amax", "amin", "max", "min", "prod",
                   "argmax", "argmin", "any", "all", "norm",
                   "linalg_vector_norm", "var", "var_mean", "std",
                   "logsumexp", "nll_loss_forward", "nll_loss_backward",
                   "nll_loss2d_forward"),
        "reduce-window": ("cumsum", "cumprod", "cummax"),
        "scatter": ("scatter", "scatter_", "scatter_add", "scatter_add_",
                    "scatter_reduce", "index_put", "index_put_",
                    "index_add", "index_add_", "_index_put_impl_"),
    }.items():
        for n in names:
            out[n] = hlo
    return out


HLO_OF = _hlo_map()

# aten ops that move nothing: allocations and metadata
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_unsafe_view", "lift_fresh", "sym_size",
         "sym_stride", "sym_numel", "sym_storage_offset", "size", "stride",
         "dim", "is_same_size", "_has_compatible_shallow_copy_type",
         "resize_", "set_", "record_stream"}
# aten ops that need a tensor's value on the host
_HOST_READS = {"_local_scalar_dense", "is_nonzero", "nonzero", "equal",
               "_unique2", "unique_consecutive", "masked_select",
               "nonzero_static", "allclose", "item", "_assert_async"}


class DryTraceError(RuntimeError):
    """An op of the traced step needs a tensor's value."""


def _dtype(t: Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _nbytes(shape, dtype: str) -> int:
    return math.prod(shape) * _DTYPE_BYTES.get(HLO_DTYPE.get(dtype, ""), 4)


def _on_meta(args, kwargs) -> bool:
    return any(isinstance(t, Tensor) and t.device.type == "meta"
               for t in tree_flatten((args, kwargs))[0])


def _site() -> str:
    """The innermost line of the port (outside this module) on the stack."""
    for fr in reversed(traceback.extract_stack()):
        if "repro_torch" in fr.filename and not fr.filename.endswith(
                "op_analysis.py"):
            return f"{fr.filename.split('src/')[-1]}:{fr.lineno} ({fr.name})"
    return "outside the port"


def op_cost(op: str, ins: list, outs: list) -> dict:
    """The reference's cost of one op: ``ins`` / ``outs`` are its tensors'
    ``(shape, dtype)``.  Returns ``dot_flops``, ``flops`` (the other
    FLOPs), ``transcendentals`` and ``bytes``."""
    c = {"dot_flops": 0.0, "flops": 0.0, "transcendentals": 0.0,
         "bytes": 0.0}
    if op in _FREE:
        return c
    hlo = HLO_OF.get(op)
    numel = sum(math.prod(s) for s, _ in outs)
    c["bytes"] = float(sum(_nbytes(s, d) for s, d in ins)
                       + sum(_nbytes(s, d) for s, d in outs))
    if hlo == "dot":
        lhs = [s for s, _ in ins if len(s) >= 1]
        # addmm / baddbmm: (bias, a, b); the rest (a, b)
        a = lhs[1] if op in ("addmm", "baddbmm") and len(lhs) > 2 else lhs[0]
        c["dot_flops"] = 2.0 * numel * (a[-1] if a else 1)
    elif hlo == "convolution":
        kern = ins[1][0] if len(ins) > 1 else ()
        last = outs[0][0][-1] if numel and outs[0][0] else 0
        c["dot_flops"] = 2.0 * numel * max(math.prod(kern) // max(last, 1),
                                           1)
    elif hlo in _TRANSCENDENTAL_OPS:
        c["transcendentals"] = float(numel)
        c["flops"] = float(numel)
    elif hlo in _ELEMENTWISE_FLOP_OPS or hlo in ("reduce", "scatter",
                                                  "reduce-window"):
        c["flops"] = float(numel)
    return c


def cost_of(records: list, launches=(), collectives=()) -> dict:
    """The whole trace's cost from its aggregated op rows
    (:meth:`OpTrace.records`), its kernel launches and its collectives'
    log: the cost keys of a dry-run cell."""
    tot = {"dot_flops": 0.0, "flops": 0.0, "transcendentals": 0.0,
           "bytes": 0.0}
    for row in records:
        c = op_cost(row["op"], [tuple(x) for x in row["ins"]],
                    [tuple(x) for x in row["outs"]])
        for k in tot:
            tot[k] += c[k] * row["count"]
    for rec in launches:
        tot["flops"] += rec["flops"]
        tot["bytes"] += rec["bytes"]
    coll = collective_totals(collectives)
    tot["bytes"] += coll.pop("_hbm_bytes")
    return {"flops": tot["dot_flops"] + tot["flops"],
            "dot_flops": tot["dot_flops"],
            "bytes": tot["bytes"],
            "transcendentals": tot["transcendentals"],
            "collectives": coll}


def collective_totals(log) -> dict:
    """Operand bytes, wire bytes and counts per kind of a collectives' log,
    and their totals (the reference's ``collectives`` keys)."""
    operand = dict.fromkeys(COLLECTIVE_KINDS, 0)
    wire = dict.fromkeys(COLLECTIVE_KINDS, 0)
    counts = dict.fromkeys(COLLECTIVE_KINDS, 0)
    hbm = 0
    for rec in log:
        k = rec["kind"]
        operand[k] += rec["operand_bytes"]
        wire[k] += rec["wire_bytes"]
        counts[k] += 1
        hbm += rec["operand_bytes"] + rec["result_bytes"]
    return {"operand_bytes": operand, "wire_bytes": wire, "counts": counts,
            "total_operand_bytes": sum(operand.values()),
            "total_wire_bytes": sum(wire.values()), "_hbm_bytes": hbm}


class OpTrace(TorchDispatchMode):
    """Records every aten op dispatched inside it (module docstring) and
    follows the bytes alive on ``device``."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # nothing here runs under torch.compile: no dynamo guard around
        # __torch_dispatch__, whose first call would import torch._dynamo
        # (seconds)
        return False

    def __init__(self, device="meta"):
        super().__init__()
        self.device_type = torch.device(device).type
        self.rows = collections.Counter()
        self.n_ops = 0
        self.live = 0
        self.peak = 0
        self._seen: dict = {}

    # ---------------- live bytes ----------------
    def _track(self, t: Tensor) -> None:
        if t.device.type != self.device_type:
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._drop, key)

    def _drop(self, key) -> None:
        self.live -= self._seen.pop(key, 0)

    def adopt(self, tree) -> int:
        """Count the storages of ``tree``'s tensors as alive (made before
        the trace); returns the bytes added."""
        before = self.live
        for t in tree_flatten(tree)[0]:
            if isinstance(t, Tensor):
                self._track(t)
        return self.live - before

    def reset_peak(self) -> None:
        self.peak = self.live

    # ---------------- ops ----------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._overloadpacket.__name__
        if name in _HOST_READS and _on_meta(args, kwargs):
            raise DryTraceError(
                f"aten.{name} needs a tensor's value, which the meta "
                f"device does not hold; called at {_site()}")
        try:
            out = func(*args, **kwargs)
        except (NotImplementedError, RuntimeError) as e:
            if not _on_meta(args, kwargs):
                raise
            raise DryTraceError(
                f"aten.{name} failed on the meta device (an op that needs "
                f"a tensor's value, or one with no meta version: {e}); "
                f"called at {_site()}") from e
        self.n_ops += 1
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, Tensor)]
        for t in outs:
            self._track(t)
        if func.is_view or name in _FREE or name in ("detach", "alias"):
            return out
        ins = tuple((tuple(t.shape), _dtype(t))
                    for t in tree_flatten((args, kwargs))[0]
                    if isinstance(t, Tensor))
        self.rows[(name, ins, tuple((tuple(t.shape), _dtype(t))
                                    for t in outs))] += 1
        return out

    def records(self) -> list:
        """The trace aggregated: ``{"op", "ins", "outs", "count"}`` rows,
        each ``ins``/``outs`` a list of ``[shape, dtype]``."""
        return [{"op": op, "ins": [[list(s), d] for s, d in ins],
                 "outs": [[list(s), d] for s, d in outs], "count": n}
                for (op, ins, outs), n in self.rows.items()]
