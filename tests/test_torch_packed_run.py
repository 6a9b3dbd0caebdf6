"""PyTorch port vs the JAX reference: segment-packed batches through the
model and ``run(spec)`` — per-document loss bitwise under a foreign scrub
(direct and flash branches), per-document loss against one document per
row and against the reference, the batch specs against the data stream's
leaves, packed runs against the reference's, a packed resume after an
injected fault bitwise, the metrics stream's padding efficiency, and the
build-time refusal of architectures that cannot pack.  Mirrors
``tests/run/test_packed_run.py``."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import pack_documents as ref_pack_documents
from repro.run import spec as ref_spec_mod
from repro.run.runner import run as ref_run
from repro_torch.core.tree import pytree_leaves
from repro_torch.data.pipeline import DataConfig, pack_documents
from repro_torch.run import (CheckpointSpec, EvalSpec, MetricsHook, ModelSpec,
                             OptSpec, RunSpec, StepSpec, build_step_program,
                             run)
from repro_torch.run.data import make_batch_iter
from torch_parity import (ARCH_ID, assert_trees_close,
                          patch_attention_thresholds, ref_params_and_copy,
                          smoke_archs)

SEQ = 24
QUIET = dict(log_fn=lambda s: None, device="cpu")
# the run-parity bounds of tests/test_torch_resume.py
LOSS_ATOL = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


def _spec(total=3, opt="adalomo", **kw):
    base = dict(
        model=ModelSpec(arch=ARCH_ID, smoke=True),
        data=DataConfig(vocab=0, seq_len=32, global_batch=4, packing=True),
        opt=OptSpec(name=opt, lr=1e-3, schedule="constant"),
        steps=StepSpec(total=total), log_every=0)
    base.update(kw)
    return RunSpec(**base)


def _ref(spec):
    return ref_spec_mod.RunSpec.from_json(spec.to_json())


def _docs(lengths):
    out, off = [], 0
    for n in lengths:
        out.append(np.arange(off, off + n + 1, dtype=np.int32))
        off += n + 1
    return out


def _placements(pb, docs, used):
    """(row, segment_id) of every used doc, located by its unique tokens."""
    out = {}
    for i in used:
        r, c = np.argwhere((pb.tokens == docs[i][0]) & (pb.segment_ids > 0))[0]
        out[i] = (int(r), int(pb.segment_ids[r, c]))
    return out


@pytest.fixture(scope="module")
def packed_case():
    ref_arch, port_arch = smoke_archs()
    docs = _docs([10, 14, 8])
    pb, used = pack_documents(docs, n_rows=2, seq_len=SEQ)
    assert used == [0, 1, 2]
    ref_params, params = ref_params_and_copy(ref_arch)
    return (docs, pb, _placements(pb, docs, used), params,
            port_arch.make_loss_fn(), ref_params,
            jax.jit(ref_arch.make_loss_fn()))


def _doc_batch(pb, row, seg_id, tokens=None):
    """``pb`` with labels kept on one document only."""
    b = pb.as_dict()
    keep = (pb.segment_ids == seg_id)
    keep[np.arange(pb.tokens.shape[0]) != row] = False
    b["labels"] = np.where(keep, b["labels"], -1).astype(np.int32)
    if tokens is not None:
        b["tokens"] = tokens
    return b


def _port_loss(loss_fn, params, b):
    with torch.no_grad():
        loss, m = loss_fn(params, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
    return float(loss), float(m["ntokens"])


@pytest.mark.parametrize("branch", ["direct", "flash"])
def test_per_document_loss_bitwise_under_foreign_scrub(packed_case, branch,
                                                       monkeypatch):
    """Same shapes: replacing every *other* document's tokens with junk
    leaves each document's loss bitwise identical — on the direct branch,
    and on the blockwise branch (thresholds shrunk so S = 24 takes it),
    where masked logits become exact zeros after the online-softmax
    correction."""
    docs, pb, places, params, loss_fn, _, _ = packed_case
    if branch == "flash":
        patch_attention_thresholds(monkeypatch, direct=8, block=8)
    for i, (row, seg_id) in places.items():
        ref, ntok = _port_loss(loss_fn, params, _doc_batch(pb, row, seg_id))
        assert ntok == len(docs[i]) - 1
        keep = (pb.segment_ids == seg_id) & \
            (np.arange(pb.tokens.shape[0])[:, None] == row)
        scrub = np.where(keep, pb.tokens, 1).astype(np.int32)
        got, _ = _port_loss(loss_fn, params,
                            _doc_batch(pb, row, seg_id, tokens=scrub))
        assert got == ref, f"doc {i}: cross-segment leakage into the loss"


def test_per_document_loss_matches_one_doc_per_row_and_reference(
        packed_case):
    """Each packed document's loss equals the same document alone in its
    own row (rtol 1e-5, the reference's bound: the reduction tree shifts
    with the in-row offset), and the reference's packed loss (1e-5)."""
    docs, pb, places, params, loss_fn, ref_params, ref_loss_fn = packed_case
    for i, (row, seg_id) in places.items():
        b = _doc_batch(pb, row, seg_id)
        packed_loss, ntok = _port_loss(loss_fn, params, b)
        solo, used = pack_documents([docs[i]], n_rows=1, seq_len=SEQ)
        assert used == [0]
        solo_loss, solo_ntok = _port_loss(loss_fn, params,
                                          _doc_batch(solo, 0, 1))
        assert solo_ntok == ntok
        np.testing.assert_allclose(packed_loss, solo_loss, rtol=1e-5)
        rl, _ = ref_loss_fn(ref_params, {k: jnp.asarray(v)
                                         for k, v in b.items()})
        np.testing.assert_allclose(packed_loss, float(rl), rtol=1e-5)


def test_packing_matches_the_reference_packer():
    docs = _docs([10, 14, 8, 30, 3])
    pb, used = pack_documents(docs, n_rows=3, seq_len=32)
    rpb, rused = ref_pack_documents(docs, n_rows=3, seq_len=32)
    assert used == rused
    for k, v in pb.as_dict().items():
        np.testing.assert_array_equal(v, rpb.as_dict()[k], err_msg=k)


def test_batch_specs_equal_the_stream_leaves():
    """``Arch.train_batch_specs(packed=True)`` is the reference's leaf set
    and equals what the packed data stream yields, leaf for leaf."""
    from repro.models.registry import get_arch as ref_get_arch
    spec = _spec()
    _, arch = smoke_archs()
    d = spec.data
    specs = arch.train_batch_specs(d.global_batch, d.seq_len, packed=True)
    concrete = next(make_batch_iter(spec, arch, 0))
    assert {k: (tuple(s), dt) for k, (s, dt) in specs.items()} == {
        k: (v.shape, torch.from_numpy(v).dtype) for k, v in concrete.items()}
    ref = ref_get_arch(ARCH_ID, smoke=True).train_batch_specs(
        d.global_batch, d.seq_len, packed=True)
    assert sorted(specs) == sorted(ref)
    assert specs["loss_mask"][1] == torch.bool
    for k in ref:
        assert tuple(specs[k][0]) == tuple(ref[k].shape), k
    assert set(arch.train_batch_specs(4, 32)) == {"tokens", "labels"}


@pytest.mark.parametrize("opt,branch", [("adalomo", "direct"),
                                        ("adalomo", "flash"),
                                        ("adamw", "direct")])
def test_packed_run_matches_reference(opt, branch, monkeypatch):
    """Three packed steps through ``run(spec)`` in both packages from the
    same weights: losses within 1e-4, params within the run-parity bounds.
    ``flash`` shrinks both packages' thresholds so that the smoke model's
    32 tokens (past its window of 8 plus a block) take the segmented
    flash branch; ``adamw`` is the unfused baseline."""
    if branch == "flash":
        patch_attention_thresholds(monkeypatch, direct=16, block=16)
    ref_arch, _ = smoke_archs()
    ref_params, params = ref_params_and_copy(ref_arch)
    spec = _spec(total=3, opt=opt)
    rres = ref_run(_ref(spec), params=ref_params, log_fn=lambda s: None)
    pres = run(spec, params=params, **QUIET)
    assert pres.program.fused == (opt == "adalomo")
    assert pres.history["step"] == [0, 1, 2]
    np.testing.assert_allclose(pres.history["loss"], rres.history["loss"],
                               atol=LOSS_ATOL, rtol=0)
    assert all(np.isfinite(pres.history["loss"]))
    assert_trees_close(pres.params, rres.params, **PARAM_TOL)


def _flaky_program(spec, fail_on_call):
    prog = build_step_program(spec, device="cpu")
    real = prog.step
    calls = {"n": 0}

    def step(params, opt_state, batch, hp):
        out = real(params, opt_state, batch, hp)
        calls["n"] += 1
        if calls["n"] == fail_on_call:
            raise torch.AcceleratorError("injected")
        return out

    prog.step = step
    return prog


def test_packed_run_recovers_bitwise_after_fault(tmp_path):
    """tests/run/test_packed_run.py::test_packed_run_recovers_bitwise_after_
    fault: a transient failure mid-packed-run restores the checkpoint,
    rewinds the packed stream and finishes with bitwise the state and
    history of the uninterrupted packed run; the metrics stream reads as
    the uninterrupted record."""
    _, arch = smoke_archs()
    mp = str(tmp_path / "metrics.jsonl")
    ev = EvalSpec(every=2, n_batches=1)
    spec = _spec(total=7, eval=ev,
                 checkpoint=CheckpointSpec(dir=str(tmp_path / "c"), every=3),
                 metrics_path=mp)
    logs = []
    res = run(spec, program=_flaky_program(spec, 6),
              params=arch.init_params(0, device="cpu"), device="cpu",
              log_fn=logs.append)
    assert any("restored step 3" in m for m in logs)
    clean = run(_spec(total=7, eval=ev),
                params=arch.init_params(0, device="cpu"), **QUIET)
    for a, b in zip(pytree_leaves((res.params, res.opt_state)),
                    pytree_leaves((clean.params, clean.opt_state))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert res.history["step"] == clean.history["step"] == list(range(7))
    assert res.history["loss"] == clean.history["loss"]
    assert res.history["eval_loss"] == clean.history["eval_loss"]
    lines = [json.loads(line) for line in open(mp)]
    assert lines[0] == {"schema": 1, "stream": "train"}
    assert [r for r in lines if r.get("event") == "recover"]
    recs = [r for r in lines if "schema" not in r and "event" not in r]
    assert [r["step"] for r in recs] == list(range(7))
    assert all(0 < r["padding_efficiency"] <= 1.0 for r in recs)


def test_padding_efficiency_equals_the_reference(tmp_path):
    """MetricsHook's ``padding_efficiency`` (real tokens / slots) over a
    packed run: the reference's values, and the packed batches' own."""
    ref_arch, _ = smoke_archs()
    ref_params, params = ref_params_and_copy(ref_arch)
    spec = _spec(total=4, metrics_path=str(tmp_path / "p.jsonl"))
    res = run(spec, params=params, **QUIET)
    assert res.find_hook(MetricsHook) is not None
    ref_run(_ref(dataclasses.replace(
        spec, metrics_path=str(tmp_path / "r.jsonl"))), params=ref_params,
        log_fn=lambda s: None)

    def effs(path):
        return [r["padding_efficiency"] for r in map(json.loads, open(path))
                if "step" in r and "event" not in r]

    got = effs(tmp_path / "p.jsonl")
    assert len(got) == 4 and got == effs(tmp_path / "r.jsonl")
    _, arch = smoke_archs()
    it = make_batch_iter(spec, arch, 0)
    own = [float((b["loss_mask"]).sum()) / b["loss_mask"].size
           for b in (next(it) for _ in range(4))]
    np.testing.assert_allclose(got, own, rtol=1e-12)


def test_loss_mask_applies_at_step_entry():
    """A batch whose labels still point across a segment where
    ``loss_mask`` is False trains exactly like the packer's own batch: the
    mask is applied at step entry, fused and unfused, per microbatch."""
    _, arch = smoke_archs()
    spec = _spec(total=1)
    batch = next(make_batch_iter(spec, arch, 0))
    dirty = dict(batch)
    dirty["labels"] = np.where(batch["loss_mask"], batch["labels"],
                               7).astype(np.int32)
    for opt, k in (("adalomo", 1), ("adalomo", 2), ("adamw", 2)):
        s = _spec(total=1, opt=opt,
                  steps=StepSpec(total=1, microbatches=k))
        out = []
        for b in (batch, dirty):
            prog = build_step_program(s, device="cpu")
            params, st = prog.init(0)
            _, _, loss, m = prog.step(params, st, {
                n: torch.from_numpy(v) for n, v in b.items()},
                prog.hparams_fn(1))
            out.append((float(loss), float(m["ntokens"]),
                        pytree_leaves(params)))
        assert out[0][:2] == out[1][:2], (opt, k)
        for a, b in zip(out[0][2], out[1][2]):
            assert torch.equal(a, b), (opt, k)


def test_architecture_that_cannot_pack_raises_at_build_time():
    """A prefix-LM config has sequence structure packing would break: the
    spec is refused when the program is built, before any step."""
    _, arch = smoke_archs()
    prefix = dataclasses.replace(
        arch, cfg=dataclasses.replace(arch.cfg, prefix_lm=True))
    assert arch.supports_packing() and not prefix.supports_packing()
    with pytest.raises(ValueError, match="packing is not supported"):
        build_step_program(_spec(), prefix, device="cpu")
    # unpacked, the same config builds: prefix-LM is ported
    prog = build_step_program(dataclasses.replace(
        _spec(), data=dataclasses.replace(_spec().data, packing=False)),
        prefix, device="cpu")
    assert prog.device.type == "cpu"
    # and the packed context refuses it as the reference's does
    from repro_torch.models.transformer import make_pro_ctx
    with pytest.raises(ValueError, match="packed"):
        make_pro_ctx(prefix.cfg)({}, {"segment_ids": torch.zeros(1, 4)})


def test_launcher_trains_packed_batches_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train ... --packing`` with AdaLomo
    through the launcher's ``main``: four finite losses, and the metrics
    stream's padding efficiency in (0, 1]."""
    from repro_torch.launch.train import main
    hist, mp = tmp_path / "h.json", tmp_path / "m.jsonl"
    main(["--arch", "h2o-danube-1.8b", "--smoke", "--steps", "4", "--batch",
          "2", "--seq", "32", "--device", "cpu", "--optimizer", "adalomo",
          "--packing", "--metrics-path", str(mp), "--history-out",
          str(hist)])
    assert "final loss" in capsys.readouterr().out
    losses = json.loads(hist.read_text())["loss"]
    assert len(losses) == 4 and all(np.isfinite(losses))
    recs = [r for r in map(json.loads, open(mp)) if "padding_efficiency" in r]
    assert len(recs) == 4
    assert all(0 < r["padding_efficiency"] <= 1 for r in recs)
