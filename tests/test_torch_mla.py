"""PyTorch port vs the JAX reference: multi-head latent attention (MLA), the
multi-token-prediction (MTP) head and deepseek-v3-671b's smoke config end
to end.

``_mla_attn`` against ``repro.models.transformer._mla_attn`` (value, and
gradients by autograd against ``jax.vjp``) on the direct branch and the
flash branch; one block body; the MTP epilogue's loss and metrics, and the
meaning the port takes for its input (``emb(token_t)``, as the reference's
code has it); two fused AdaLomo steps; prefill and the absorbed latent
decode (logits and the ``ckv``/``kr`` cache); greedy tokens of ``Engine``;
``labels_mtp`` from the run layer's stream; ``run(spec)`` and the launcher;
the refusals (packed MTP batches, paged serving of MLA); the MTP ``outer``
tree through the checkpoint both ways.  fp32 on the CPU, inputs made with
numpy from a seed, weights from the reference's ``init_params``."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.core import optimizers as ref_opt
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.models import transformer as ref_T
from repro.run import spec as ref_spec_mod
from repro.run.data import make_batch_iter as ref_batch_iter
from repro.run.runner import run as ref_run
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefConfig
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import params_from_numpy
from repro_torch.core import optimizers as opt_lib
from repro_torch.core.tree import (pytree_leaves, pytree_unflatten,
                                   tree_flatten_with_path, tree_leaves,
                                   tree_map)
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import transformer as T
from repro_torch.run import spec as spec_mod
from repro_torch.run.data import make_batch_iter
from repro_torch.run.runner import run
from repro_torch.serve.engine import (Engine, PagedEngine, PagedServeConfig,
                                      ServeConfig)
from torch_parity import (CPU, assert_trees_close, convert_opt_state,
                          jax_batch, jax_flat, np_f32, port_flat,
                          smoke_archs, torch_batch)

V3_ID = "deepseek-v3-671b"
# fp32 on both sides, other summation orders: values of the attention and
# of one block within 1e-5 (gradients: _assert_grads_close)
TOL = dict(rtol=1e-5, atol=1e-5)
# |Δloss| and parameters after fused steps: the reference's own fused
# drop-in bounds (tests/test_torch_configs.py's LOSS_TOL / PARAM_TOL)
LOSS_TOL = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
# metrics of a fused step: tests/test_torch_configs.py's bound
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def v3():
    """The smoke config in both packages, and ``weights(seed)``: the
    reference's ``init_params`` (compiled once for the module) and the same
    weights converted for the port."""
    ref, port = smoke_archs(V3_ID)
    init = jax.jit(ref.init_params)

    def weights(seed: int = 0):
        rp = init(jax.random.PRNGKey(seed))
        return rp, params_from_numpy(jax.device_get(rp), CPU)

    return ref, port, weights


def _assert_grads_close(port_tree, ref_tree, what):
    """Gradients within 1e-5 relative, and 1e-5 of each leaf's largest
    element: a weight's gradient is a sum over every token, whose fp32
    rounding scales with the sum's size and not with one element's (at
    2112 tokens an element that cancels to 0.05 among values of 30 is off
    by 3e-5 in either package's order)."""
    a, b = port_flat(port_tree), jax_flat(ref_tree)
    assert [p for p, _ in a] == [p for p, _ in b], what
    for (path, x), (_, y) in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(y).max()),
                                   err_msg=f"{what} {path}")


def _mtp_batch(vocab: int, B: int, S: int, seed: int) -> dict:
    """Tokens, labels and the labels shifted once more (-1 at the end), as
    the run layer makes them; a few labels ignored."""
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, vocab, (B, S)).astype(np.int32)
    lab[0, :3] = -1
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": lab,
            "labels_mtp": np.concatenate(
                [lab[:, 1:], -np.ones((B, 1), np.int32)], 1)}


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


# --------------------------------------------------------------------------
# MLA attention and one block
# --------------------------------------------------------------------------

@pytest.mark.parametrize("S", [64, 2112], ids=["direct", "flash"])
def test_mla_attention_matches_reference(v3, S):
    """Value and the gradients of sum(out * t) with respect to h and every
    attention weight.  2112 tokens (no window) take the flash branch with
    its recomputing backward in both packages; 64 the direct one."""
    ref, port, weights = v3
    rp, pp = weights(1)
    rattn = _layer0(rp["stacks"]["blocks"]["attn"])
    pattn = T._layer(pp["stacks"]["blocks"], 0)["attn"]
    rng = np.random.default_rng(S)
    h = rng.standard_normal((1, S, ref.cfg.d_model)).astype(np.float32)
    t = rng.standard_normal((1, S, ref.cfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)

    @jax.jit
    def ref_vjp(p, hh, tt):
        out, vjp = jax.vjp(lambda p, hh: ref_T._mla_attn(
            p, ref.cfg, hh, jnp.asarray(pos), None), p, hh)
        return out, vjp(tt)

    rout, (rgp, rgh) = ref_vjp(rattn, jnp.asarray(h), jnp.asarray(t))

    p_req = tree_map(lambda a: a.detach().requires_grad_(True), pattn)
    h_req = torch.from_numpy(h).requires_grad_(True)
    out = T._mla_attn_kv(p_req, port.cfg, h_req, torch.from_numpy(pos))[0]
    grads = torch.autograd.grad(out, tree_leaves(p_req) + [h_req],
                                torch.from_numpy(t))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(rout), **TOL)
    it = iter(grads[:-1])
    _assert_grads_close({"h": grads[-1], **tree_map(lambda _: next(it),
                                                    p_req)},
                        {"h": rgh, **rgp}, f"mla grads S={S}")


def test_block_body_matches_reference(v3):
    """One MoE block with MLA attention: the carry's hidden state and aux
    loss, and the gradients of both through the block."""
    ref, port, weights = v3
    rp, pp = weights(2)
    S = 24
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, S, ref.cfg.d_model)).astype(np.float32)
    t = rng.standard_normal(x.shape).astype(np.float32)
    rbody = ref_T.make_block_body(ref.cfg)
    pbody = T.make_block_body(port.cfg)

    def ref_f(p, xx):
        y, aux = rbody(p, ({}, {"pos": jnp.arange(S, dtype=jnp.float32)}),
                       (xx, jnp.zeros((), jnp.float32)), 0)
        return jnp.sum(y * jnp.asarray(t)) + aux, (y, aux)

    (rval, (ry, raux)), (rgp, rgx) = jax.jit(jax.value_and_grad(
        ref_f, argnums=(0, 1), has_aux=True))(
            _layer0(rp["stacks"]["blocks"]), jnp.asarray(x))
    p_req = tree_map(lambda a: a.detach().requires_grad_(True),
                     T._layer(pp["stacks"]["blocks"], 0))
    x_req = torch.from_numpy(x).requires_grad_(True)
    y, aux = pbody(p_req, ({}, {"pos": torch.arange(S, dtype=torch.int32)}),
                   (x_req, torch.zeros(())), 0)
    val = torch.sum(y * torch.from_numpy(t)) + aux
    grads = torch.autograd.grad(val, tree_leaves(p_req) + [x_req])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(float(aux.detach()), float(raux), rtol=1e-5)
    it = iter(grads[:-1])
    _assert_grads_close({"x": grads[-1], **tree_map(lambda _: next(it),
                                                    p_req)},
                        {"x": rgx, **rgp}, "block grads")


# --------------------------------------------------------------------------
# The MTP head
# --------------------------------------------------------------------------

def test_mtp_epilogue_matches_reference(v3):
    """The epilogue's loss (cross entropy + aux + mtp_weight x the MTP
    head's mean cross entropy) and metrics, and the gradients of the loss
    with respect to the outer tree (embedding, head, the MTP block) and the
    carry."""
    ref, port, weights = v3
    rp, pp = weights(3)
    b = _mtp_batch(ref.cfg.vocab, 2, 16, seed=3)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, ref.cfg.d_model)).astype(np.float32)
    aux = np.float32(0.25)

    def ref_f(outer, xx):
        return ref_T.make_epilogue(ref.cfg)(outer, (xx, jnp.asarray(aux)),
                                            jax_batch(b))

    (rloss, rmetrics), (rgo, rgx) = jax.jit(jax.value_and_grad(
        ref_f, argnums=(0, 1), has_aux=True))(rp["outer"], jnp.asarray(x))
    o_req = tree_map(lambda a: a.detach().requires_grad_(True), pp["outer"])
    x_req = torch.from_numpy(x).requires_grad_(True)
    loss, metrics = T.make_epilogue(port.cfg)(
        o_req, (x_req, torch.tensor(aux)), torch_batch(b))
    grads = torch.autograd.grad(loss, tree_leaves(o_req) + [x_req])
    loss = loss.detach()
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    for k in rmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(rmetrics[k]),
                                   rtol=1e-5, atol=1e-7)
    it = iter(grads[:-1])
    g_outer = tree_map(lambda _: next(it), o_req)
    _assert_grads_close({"x": grads[-1], **g_outer}, {"x": rgx, **rgo},
                        "epilogue grads")
    # the MTP head takes part: its block and projection get gradients
    assert float(g_outer["mtp_proj"].abs().sum()) > 0
    assert float(g_outer["mtp_block"]["attn"]["w_uk"].abs().sum()) > 0
    # the loss is the main cross entropy + aux + 0.1 x the MTP metric
    no_mtp = T.make_epilogue(dataclasses.replace(port.cfg, mtp=False))(
        pp["outer"], (torch.from_numpy(x), torch.tensor(aux)),
        torch_batch(b))[0]
    np.testing.assert_allclose(
        float(loss), float(no_mtp) + 0.1 * float(metrics["mtp_loss"]),
        rtol=1e-6)


def test_mtp_head_embeds_the_current_token(v3):
    """Pinned meaning: the reference's comment says the MTP head reads
    ``[h_t ; emb(token_{t+1})]``, its code embeds ``tokens`` unshifted, i.e.
    ``emb(token_t)``.  The port's MTP loss equals a hand-built head over
    ``emb(token_t)`` and differs from one over ``emb(token_{t+1})``."""
    ref, port, weights = v3
    _, pp = weights(4)
    cfg, outer = port.cfg, pp["outer"]
    b = torch_batch(_mtp_batch(cfg.vocab, 2, 12, seed=4))
    h = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32))
    got, n = T._mtp_loss(outer, cfg, h, b)

    def by_hand(tokens):
        x = torch.cat([h, torch.nn.functional.embedding(
            tokens.long(), outer["tok_embed"])], -1) @ outer["mtp_proj"]
        body = T.make_block_body(dataclasses.replace(cfg, moe=None,
                                                     mtp=False))
        x, _ = body(outer["mtp_block"],
                    ({}, {"pos": torch.arange(12, dtype=torch.int32)}),
                    (x, torch.zeros(())), 0)
        x = T.L.norm_apply(outer["mtp_norm"], x, kind=cfg.norm)
        return T.cross_entropy(x @ outer["head"], b["labels_mtp"])[0]

    nxt = torch.cat([b["tokens"][:, 1:], b["tokens"][:, :1]], 1)
    assert float(n) == float((b["labels_mtp"] >= 0).sum())
    np.testing.assert_allclose(float(got), float(by_hand(b["tokens"])),
                               rtol=1e-6)
    assert abs(float(got) - float(by_hand(nxt))) > 1e-3


# --------------------------------------------------------------------------
# The whole model: fused steps, serving, the run layer
# --------------------------------------------------------------------------

def test_fused_adalomo_steps_match_reference(v3):
    """Two fused AdaLomo steps from the same weights and batch: losses,
    metrics (the port adds ``aux_loss`` and ``mtp_loss``), params and the
    OptState, at the fused drop-in bounds."""
    ref, port, weights = v3
    rp, pp = weights(5)
    b = _mtp_batch(ref.cfg.vocab, 2, 16, seed=5)
    ropt = ref_opt.get_opt("adalomo", backend="jnp")
    popt = opt_lib.get_opt("adalomo", backend="torch")
    rstep = jax.jit(lambda p, s, bb: ref.make_fused_train_step(ropt)(
        p, s, bb, hparams=1e-3))
    pstep = port.make_fused_train_step(popt)
    rs, ps = ropt.init(rp), popt.init(pp)
    for _ in range(2):
        rp, rs, rloss, rmetrics = rstep(rp, rs, jax_batch(b))
        _, ps, ploss, pmetrics = pstep(pp, ps, torch_batch(b), hparams=1e-3)
        assert abs(float(ploss) - float(rloss)) < LOSS_TOL
        for k in rmetrics:
            np.testing.assert_allclose(float(pmetrics[k]), float(rmetrics[k]),
                                       **METRIC_TOL)
        assert {"aux_loss", "mtp_loss"} <= set(pmetrics)
    assert_trees_close(pp, rp, what="v3 fused", **PARAM_TOL)
    conv = convert_opt_state(rs)
    assert int(ps.step) == int(conv.step) == 2
    for (kp, a), (_, c) in zip(tree_flatten_with_path(ps.moments),
                               tree_flatten_with_path(conv.moments)):
        for x, y in zip(a, c):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_allclose(np_f32(x), np_f32(y), rtol=1e-4,
                                           atol=1e-7, err_msg="/".join(kp))


def test_prefill_and_latent_decode_match_reference(v3):
    """``make_prefill_step`` then three ``make_decode_step`` calls: the
    logits and the latent cache (``ckv [L,B,W,r]``, ``kr [L,B,W,d_rope]``,
    ``pos``, ``cur``) after each, 1e-5.  The prompt fills the ring, so the
    decode steps overwrite its oldest slots, as the reference's do."""
    ref, port, weights = v3
    rp, pp = weights(6)
    rng = np.random.default_rng(6)
    toks = rng.integers(1, ref.cfg.vocab, (2, 10)).astype(np.int32)
    rlog, rcache = ref.make_prefill_step()(rp, {"tokens": jnp.asarray(toks)})
    plog, pcache = port.make_prefill_step()(pp, {"tokens":
                                                 torch.from_numpy(toks)})
    rdec, pdec = jax.jit(ref.make_decode_step()), port.make_decode_step()
    for i in range(4):
        np.testing.assert_allclose(plog.numpy(), np.asarray(rlog), **TOL,
                                   err_msg=f"logits after {i} decode steps")
        assert set(pcache) == set(rcache) == {"ckv", "kr", "pos", "cur"}
        for k in ("ckv", "kr"):
            np.testing.assert_allclose(pcache[k].numpy(),
                                       np.asarray(rcache[k]), **TOL)
        np.testing.assert_array_equal(pcache["pos"].numpy(),
                                      np.asarray(rcache["pos"]))
        assert int(pcache["cur"]) == int(rcache["cur"]) == 10 + i
        nxt = np.argmax(np.asarray(rlog), -1).astype(np.int32)[:, None]
        rlog, rcache = rdec(rp, rcache, {"tokens": jnp.asarray(nxt)})
        plog, pcache = pdec(pp, pcache, {"tokens": torch.from_numpy(nxt)})
    want = ref.init_cache(3, 7)
    got = port.init_cache(3, 7, device="cpu")
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_array_equal(np_f32(got[k]), np_f32(want[k]))


@pytest.mark.parametrize("prompts", [
    [[5, 17, 23, 9, 2, 11], [101, 44, 3, 3, 8, 61]],
    [[5, 17, 23, 9], [101, 44], [7] * 6]], ids=["equal", "ragged"])
def test_engine_greedy_matches_reference(v3, prompts):
    """The legacy Engine over the latent cache: greedy tokens equal to the
    JAX Engine's (temperature 0)."""
    ref, port, weights = v3
    rp, pp = weights(7)
    want = RefEngine(ref, rp, RefConfig(max_new_tokens=8)).generate(prompts)
    got = Engine(port, pp, ServeConfig(max_new_tokens=8),
                 device=CPU).generate(prompts)
    assert got == want


def _run_specs(**over):
    kw = dict(seed=3, log_every=0)
    mk = lambda m: m.RunSpec(                               # noqa: E731
        model=m.ModelSpec(V3_ID, smoke=True),
        data=(DataConfig if m is spec_mod else RefDataConfig)(
            vocab=0, seq_len=16, global_batch=2, seed=3),
        opt=m.OptSpec(name="adalomo", lr=1e-3),
        steps=m.StepSpec(total=3), **kw, **over)
    return mk(ref_spec_mod), mk(spec_mod)


def test_labels_mtp_stream_equals_reference(v3):
    """``run/data.py``'s stream: every leaf of the reference's batches,
    ``labels_mtp`` included, bit for bit, from a resumed start too; and the
    leaves are ``train_batch_specs``'s."""
    ref, port, weights = v3
    rspec, pspec = _run_specs()
    for start in (0, 5):
        rit = ref_batch_iter(rspec, ref, start)
        pit = make_batch_iter(pspec, port, start)
        for _ in range(3):
            rb, pb = next(rit), next(pit)
            assert sorted(pb) == sorted(rb)
            for k in rb:
                np.testing.assert_array_equal(pb[k], rb[k])
            np.testing.assert_array_equal(pb["labels_mtp"][:, :-1],
                                          pb["labels"][:, 1:])
            assert (pb["labels_mtp"][:, -1] == -1).all()
    specs = port.train_batch_specs(2, 16)
    assert specs == {k: ((2, 16), torch.int32)
                     for k in ("tokens", "labels", "labels_mtp")}
    assert sorted(specs) == sorted(ref.train_batch_specs(2, 16))
    assert "labels_mtp" not in port.train_batch_specs(2, 16, labels=False)


def test_run_and_launcher_train_mtp(v3, tmp_path, capsys):
    """Three steps of ``run(spec)`` in both packages from the same weights:
    losses within 1e-4, params at the fused bounds; then the launcher's
    recipe ``--arch deepseek-v3-671b --smoke`` on the CPU."""
    ref, _, weights = v3
    rspec, pspec = _run_specs()
    rp, pp = weights()
    rres = ref_run(rspec, params=rp, log_fn=lambda s: None)
    pres = run(pspec, params=pp, device="cpu", log_fn=lambda s: None)
    np.testing.assert_allclose(pres.history["loss"], rres.history["loss"],
                               atol=LOSS_TOL, rtol=0)
    assert_trees_close(pres.params, rres.params, **PARAM_TOL)
    from repro_torch.launch.train import main
    hist = tmp_path / "h.json"
    main(["--arch", V3_ID, "--smoke", "--steps", "4", "--batch", "2",
          "--seq", "32", "--device", "cpu", "--history-out", str(hist)])
    assert "final loss" in capsys.readouterr().out
    losses = json.loads(hist.read_text())["loss"]
    assert len(losses) == 4 and all(np.isfinite(losses))


# --------------------------------------------------------------------------
# Refusals, and the MTP tree through the checkpoint
# --------------------------------------------------------------------------

def test_packed_mtp_batches_and_paged_serving_refuse(v3):
    """As the reference: a packed (segment-id) batch of an MTP model raises
    ``ValueError``, packing is refused up front, and paged serving refuses
    MLA at every entry (the engine, the registry and the module)."""
    ref, port, weights = v3
    _, pp = weights()
    b = torch_batch(_mtp_batch(port.cfg.vocab, 2, 8, seed=8))
    b["segment_ids"] = torch.ones(2, 8, dtype=torch.int32)
    b["positions"] = torch.arange(8, dtype=torch.int32).expand(2, 8)
    with pytest.raises(ValueError, match="MTP"):
        T.make_pro_ctx(port.cfg)(pp["outer"], b)
    assert not port.supports_packing()
    with pytest.raises(ValueError, match="packing"):
        port.train_batch_specs(2, 8, packed=True)
    assert not port.supports_paged_serving() and \
        not ref.supports_paged_serving()
    with pytest.raises(ValueError, match="paged serving"):
        PagedEngine(port, pp, PagedServeConfig(), device=CPU)
    for call in (port.make_prefill_kv_step, port.make_paged_decode_step,
                 lambda: port.init_page_pool(8, 4, device="cpu")):
        with pytest.raises(ValueError, match="paged serving"):
            call()
    for call in (lambda: T.make_prefill_kv_step(port.cfg),
                 lambda: T.make_paged_decode_step(port.cfg),
                 lambda: T.init_page_pool(port.cfg, 8, 4, device="cpu")):
        with pytest.raises(ValueError, match="GQA caches only"):
            call()


def test_mtp_outer_tree_crosses_the_checkpoint_both_ways(v3, tmp_path):
    """Params and a non-zero AdaLomo state of the MTP model (``outer`` holds
    the nested ``mtp_block``) saved by one package and restored by the
    other, bitwise, in the same leaf order."""
    ref, _, weights = v3
    rp, _ = weights(9)
    ropt = ref_opt.get_opt("adalomo")
    rp, rs = jax.jit(lambda p: ropt.step(
        p, jax.tree.map(lambda x: jnp.cos(x) * 0.01, p), ropt.init(p),
        1e-3))(rp)
    ref_tree = (rp, rs)
    port_tree = (params_from_numpy(jax.device_get(rp), CPU),
                 convert_opt_state(rs))
    paths = ["/".join(kp) for kp, _ in tree_flatten_with_path(
        port_tree[0]["outer"])]
    jpaths = ["/".join(str(k.key) for k in kp) for kp, _ in
              jax.tree_util.tree_flatten_with_path(rp["outer"])[0]]
    assert paths == jpaths and "mtp_block/attn/w_uk" in paths
    assert [tuple(t.shape) for t in pytree_leaves(port_tree)] == \
        [a.shape for a in jax.tree_util.tree_leaves(ref_tree)]
    # the port's files restore in the reference, bitwise
    CheckpointManager(tmp_path / "p", async_write=False).save(3, port_tree)
    step, got, _ = RefManager(tmp_path / "p").restore(template=ref_tree)
    assert step == 3
    for a, c in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref_tree)):
        assert a.dtype == c.dtype and a.shape == c.shape
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))
    # the reference's files restore in the port, bitwise
    RefManager(tmp_path / "r", async_write=False).save(4, ref_tree)
    template = pytree_unflatten(
        port_tree, [torch.zeros_like(t) for t in pytree_leaves(port_tree)])
    step, got, _ = CheckpointManager(tmp_path / "r").restore(
        template=template)
    assert step == 4
    for a, c in zip(pytree_leaves(got), jax.tree_util.tree_leaves(ref_tree)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    w = got[1].moments["outer"]["mtp_block"]["attn"]["w_uv"]
    assert tuple(w.r.shape) == (16,) and tuple(w.c.shape) == (64,)
