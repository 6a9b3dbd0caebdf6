"""The dry run's cost model and live-bytes tracker
(``repro_torch/launch/op_analysis.py``) against the reference's
``hlo_analysis``: op for op on small jnp functions and their torch forms,
the prefill step's dot FLOPs on danube's smoke config, the fused train
step's once the products XLA drops are added, a peak reckoned by hand, the
ops that need a value, and the kernels' launch records."""
import collections
import re

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from repro.launch import hlo_analysis as H
from repro.models import mamba2 as ref_mamba2
from repro.models.registry import get_arch as ref_get_arch
from repro_torch.kernels import dry
from repro_torch.launch import dryrun as D
from repro_torch.launch.op_analysis import (HLO_OF, DryTraceError, OpTrace,
                                            cost_of, op_cost)
from repro_torch.models import mamba2 as port_mamba2
from repro_torch.models.registry import get_arch
from repro_torch.run import ModelSpec, OptSpec, RunSpec, StepSpec
from repro_torch.data.pipeline import DataConfig

DANUBE = "h2o-danube-1.8b"
# the ops that do arithmetic, by HLO name (the rest move or reshape data)
COMPUTE = ({"dot", "convolution", "reduce", "scatter", "reduce-window"}
           | H._ELEMENTWISE_FLOP_OPS | H._TRANSCENDENTAL_OPS)


def _hlo_ops(fn, *shapes) -> list:
    """``(hlo op, result shape, flops, transcendentals, bytes)`` of every
    arithmetic instruction of ``fn``'s HLO as XLA lowers it, no pass run
    (one instruction an op, as the port dispatches them)."""
    args = [jnp.zeros(s, jnp.float32) for s in shapes]
    text = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_disable_all_hlo_passes": True}).as_text()
    comps, entry = H.parse_hlo(text)
    an = H._Analyzer(comps)
    out = []

    def walk(name):
        for ins in comps[name].instructions:
            if ins.opcode in ("call", "fusion"):
                walk(re.search(r"(?:calls|to_apply)=%?([\w.\-]+)",
                               ins.line).group(1))
            elif ins.opcode in COMPUTE:
                c = an.instr_cost(comps[name], ins)
                out.append((ins.opcode, ins.result_shapes[0][1], c.flops,
                            c.transcendentals, c.bytes))
    walk(entry)
    return out


def _port_ops(fn, *shapes) -> list:
    """The same list of the port's trace of ``fn`` on meta tensors."""
    tr = OpTrace("meta")
    with tr:
        fn(*[torch.empty(s, device="meta") for s in shapes])
    out = []
    for row in tr.records():
        ins = [tuple(x) for x in row["ins"]]
        outs = [tuple(x) for x in row["outs"]]
        c = op_cost(row["op"], ins, outs)
        hlo = HLO_OF.get(row["op"])
        if hlo in COMPUTE:
            out += [(hlo, tuple(outs[0][0]), c["dot_flops"] + c["flops"],
                     c["transcendentals"], c["bytes"])] * row["count"]
    return out


def _conv_jnp(x, w):
    return jax.lax.conv_general_dilated(
        jnp.pad(x, ((0, 0), (0, 0), (3, 0))), w[:, None, :], (1,),
        [(0, 0)], feature_group_count=x.shape[1],
        dimension_numbers=("NCH", "OIH", "NCH"))


def _conv_torch(x, w):
    return F.conv1d(F.pad(x, (3, 0)), w[:, None, :], groups=x.shape[1])


B, C, S = 2, 6, 8
N = B * S * C          # the depthwise conv's result elements
# name -> (jnp fn, torch fn, shapes, the named differences: HLO entries
# the port has not, and port entries the HLO has not)
CASES = {
    "bmm": (jnp.matmul, torch.matmul, [(4, 8, 16), (4, 16, 32)], [], []),
    "einsum": (lambda a, b: jnp.einsum("bqd,bkd->bqk", a, b),
               lambda a, b: torch.einsum("bqd,bkd->bqk", a, b),
               [(4, 8, 16), (4, 12, 16)], [], []),
    "exp": (jnp.exp, torch.exp, [(8, 16)], [], []),
    "add": (jnp.add, torch.add, [(8, 16), (8, 16)], [], []),
    # XLA's reduce reads its init value, a scalar of the dtype: 4 bytes
    "sum": (jnp.sum, torch.sum, [(8, 16)], [("reduce", (), 1.0, 0.0, 516.0
                                            + 4)],
            [("reduce", (), 1.0, 0.0, 516.0)]),
    # a depthwise convolution (mamba2's kernel as a conv) in both packages
    "conv1d": (_conv_jnp, _conv_torch, [(B, C, S), (C, 4)], [], []),
    # mamba2's depthwise causal conv as the models write it, k = 4
    # multiply-adds: the port's first add is to zeros_like(x), which jax
    # drops when it traces (4 adds to the port's 5); in the HLO the
    # weight's column [C] and the bias [C] are broadcast to the result's
    # [B, S, C] before the multiply and the bias add, so those operands
    # are counted there at N elements and here at C (4 multiplies and
    # one add: 4 (N - C) bytes each)
    "mamba2_conv": (ref_mamba2._causal_conv, port_mamba2._causal_conv,
                    [(B, S, C), (C, 4), (C,)],
                    [("multiply", (B, S, C), N, 0.0, 12.0 * N)] * 4
                    + [("add", (B, S, C), N, 0.0, 12.0 * N)],
                    [("multiply", (B, S, C), N, 0.0, 8.0 * N + 4 * C)] * 4
                    + [("add", (B, S, C), N, 0.0, 8.0 * N + 4 * C),
                       ("add", (B, S, C), N, 0.0, 12.0 * N)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cost_matches_hlo_analysis_op_for_op(case):
    """Each arithmetic op's FLOPs, transcendentals and bytes equal those
    ``hlo_analysis`` gives its HLO instruction, apart from the named
    differences (reckoned from shapes)."""
    jf, tf, shapes, only_hlo, only_port = CASES[case]
    hlo = collections.Counter(_hlo_ops(jf, *shapes))
    port = collections.Counter(_port_ops(tf, *shapes))
    hlo.subtract(collections.Counter(only_hlo))
    port.subtract(collections.Counter(only_port))
    assert +hlo == +port and not -hlo and not -port, (hlo, port)


def test_whole_cost_sums_the_ops():
    """``cost_of`` keeps dot FLOPs apart and adds launches' records."""
    tr = OpTrace("meta")
    a = torch.empty(4, 8, 16, device="meta")
    b = torch.empty(4, 16, 32, device="meta")
    with tr:
        torch.exp(torch.matmul(a, b))
    rec = {"kernel": "k", "shape": {}, "flops": 7.0, "bytes": 11.0}
    c = cost_of(tr.records(), [rec])
    assert c["dot_flops"] == 2 * 4 * 8 * 32 * 16
    assert c["flops"] == c["dot_flops"] + 4 * 8 * 32 + 7.0
    assert c["transcendentals"] == 4 * 8 * 32
    assert c["bytes"] == 4 * (4 * 8 * 16 + 4 * 16 * 32 + 3 * 4 * 8 * 32) + 11


class _DotOnly(H._Analyzer):
    """The reference's analyzer counting only dot and convolution FLOPs
    (through loops, calls and fusions)."""

    def instr_cost(self, comp, instr):
        c = super().instr_cost(comp, instr)
        out = H.Cost()
        if instr.opcode in ("dot", "convolution", "while", "call", "fusion",
                            "conditional", "map", "custom-call"):
            out.flops = c.flops
        return out


def _ref_dot_flops(fn, *args) -> float:
    comps, entry = H.parse_hlo(jax.jit(fn).lower(*args).compile().as_text())
    return _DotOnly(comps).comp_cost(entry).flops


def test_prefill_dot_flops_equal_reference():
    """danube's smoke prefill on one device: the port's traced dot FLOPs
    are the reference's, from its compiled HLO."""
    Bt, St = 2, 32
    ref = ref_get_arch(DANUBE, smoke=True)
    p_sds = jax.eval_shape(ref.init_params, jax.random.PRNGKey(0))
    want = _ref_dot_flops(ref.make_prefill_step(), p_sds,
                          ref.train_batch_specs(Bt, St, labels=False))
    arch = get_arch(DANUBE, smoke=True)
    _, tr = D.trace(
        lambda: (arch.init_params(0, device="meta"), D.meta_batch(
            arch.train_batch_specs(Bt, St, labels=False))),
        arch.make_prefill_step())
    assert tr.cost()["dot_flops"] == want > 0


def test_fused_train_dot_flops_equal_reference_with_dropped_products():
    """danube's smoke fused AdaLomo step: the port's dot FLOPs are the
    reference's plus, a layer, the re-run's last product (the MLP's
    ``h @ w_down``, 2 · tokens · d_ff · d_model), which autograd's re-run
    computes and XLA drops from the VJP (the layer's output is not needed
    for its gradients)."""
    from repro.data.pipeline import DataConfig as RefData
    from repro.run import (ModelSpec as RM, OptSpec as RO, RunSpec as RS,
                           StepSpec as RSt, build_step_program)
    Bt, St = 2, 32
    rspec = RS(model=RM(arch=DANUBE, smoke=True),
               data=RefData(vocab=0, seq_len=St, global_batch=Bt),
               opt=RO(name="adalomo", schedule="constant"),
               steps=RSt(total=1, fused=True))
    prog = build_step_program(rspec)
    comps, entry = H.parse_hlo(prog.lower().compile().as_text())
    want = _DotOnly(comps).comp_cost(entry).flops
    spec = RunSpec(model=ModelSpec(DANUBE, smoke=True),
                   data=DataConfig(vocab=0, seq_len=St, global_batch=Bt),
                   opt=OptSpec(name="adalomo", schedule="constant"),
                   steps=StepSpec(total=1, fused=True))
    cfg = get_arch(DANUBE, smoke=True).cfg
    dropped = cfg.n_layers * 2 * Bt * St * cfg.d_ff * cfg.d_model
    assert D.trace_train(spec).cost()["dot_flops"] == want + dropped


def _peak_case(device):
    """x [256] f32 alive before; y = x * 2 (1 KiB), z = y + 1 (1 KiB),
    y freed, w = z.sum() (4 B), a view of z (nothing): peak 3 KiB while
    x, y and z are alive; x, z and w after, 2 KiB + 4."""
    tr = OpTrace(device)
    x = torch.zeros(256, device=device)
    tr.adopt(x)
    with tr:
        y = x * 2
        z = y + 1
        del y
        w = z.sum()
        v = z.view(16, 16)
    return tr, (x, w, v, z)


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_tracker_peak_hand_reckoned(device):
    tr, keep = _peak_case(device)
    assert tr.peak == 3 * 1024
    assert tr.live == 2 * 1024 + 4
    del keep


def test_tracker_same_peak_meta_and_cpu_on_a_step():
    """One smoke fused step's trace gives the same peak on the meta device
    and on the CPU (the plain path on both)."""
    spec = RunSpec(model=ModelSpec(DANUBE, smoke=True),
                   data=DataConfig(vocab=0, seq_len=16, global_batch=2),
                   opt=OptSpec(name="adalomo", schedule="constant",
                               kwargs={"backend": "torch"}),
                   steps=StepSpec(total=1, fused=True))
    peaks = []
    for device in ("meta", "cpu"):
        from repro_torch.run.program import build_step_program
        prog = build_step_program(spec, device=device)
        params, state = prog.init(0)
        batch = {k: torch.zeros(shape, dtype=dt, device=device)
                 for k, (shape, dt) in prog.arch.train_batch_specs(
                     2, 16).items()}
        tr = OpTrace(device)
        tr.adopt((params, state, batch))
        tr.reset_peak()
        with tr:
            prog.step(params, state, batch, prog.hparams_fn(1))
        peaks.append(tr.peak)
    assert peaks[0] == peaks[1] > 0


HOST_READS = {"item": lambda t: t.sum().item(),
              "tolist": lambda t: t.tolist(),
              "bool": lambda t: bool(t.sum() > 0),
              "nonzero": lambda t: torch.nonzero(t)}


@pytest.mark.parametrize("case", sorted(HOST_READS))
def test_host_read_raises_naming_op_and_site(case):
    t = torch.empty(4, device="meta")
    with pytest.raises(DryTraceError, match=r"aten\.\w+ (needs|failed on the "
                                            r"meta device.*needs) a tensor's "
                                            r"value.*called at"):
        with OpTrace("meta"):
            HOST_READS[case](t)


def test_views_are_free_and_copies_are_not():
    tr = OpTrace("meta")
    t = torch.empty(8, 16, device="meta")
    with tr:
        t.view(16, 8).t().unsqueeze(0)[..., 3:].expand(2, 8, 13).detach()
    assert cost_of(tr.records())["bytes"] == 0
    with tr:
        t.t().contiguous()
    assert cost_of(tr.records())["bytes"] == 2 * 8 * 16 * 4


def test_launch_recorded_on_meta_only():
    """A meta tensor records K1/K2's launches once each under the kernel's
    name, with the counter's FLOPs (K1 + K2 = ``adalomo_update_counters``);
    a CPU tensor takes the plain version and records nothing."""
    from repro_torch.kernels.adalomo_update import adalomo_update as K
    from repro_torch.kernels.adalomo_update.ops import adalomo_update
    from repro_torch.telemetry.kernels import adalomo_update_counters
    m, n = 64, 48
    for device, want in (("meta", ["adalomo_stats", "adalomo_update"]),
                         ("cpu", [])):
        p = torch.zeros(m, n, device=device)
        g = torch.ones(m, n, device=device)
        r, c = torch.zeros(m, device=device), torch.zeros(n, device=device)
        before = (K.adalomo_stats.launches, K.adalomo_update.launches)
        dry.SINK = []
        try:
            adalomo_update(p, g, r, c, 1e-3, 1.0)
            recs = dry.SINK
        finally:
            dry.SINK = None
        grew = (K.adalomo_stats.launches - before[0],
                K.adalomo_update.launches - before[1])
        K.adalomo_stats.launches, K.adalomo_update.launches = before
        assert [x["kernel"] for x in recs] == want
        assert grew == ((1, 1) if want else (0, 0))
        if want:
            whole = adalomo_update_counters(m, n)
            assert sum(x["flops"] for x in recs) == whole.flops
            assert sum(x["bytes"] for x in recs) == whole.bytes
