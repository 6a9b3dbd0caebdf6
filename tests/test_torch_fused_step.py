"""PyTorch port vs the JAX reference: the fused backward-and-update engine
(``core/fused.py``) as a whole — fused AdaLomo steps at converted weights
against the reference's fused step, fused == unfused within the port, the
two-pass ``global_grad_norm`` mode, and LOMO (fused ``sgd``)."""
import jax
import numpy as np
import pytest
import torch

from repro.core import optimizers as ref_opt
from repro.core.api import no_decay_1d as ref_no_decay_1d
from repro.models.transformer import make_fused_spec as ref_make_fused_spec
from repro_torch.core import fused, optimizers as opt_lib
from repro_torch.core.api import no_decay_1d
from repro_torch.core.tree import tree_flatten_with_path, tree_leaves, tree_map
from repro_torch.models.transformer import make_fused_spec
from torch_parity import (assert_trees_close, convert_opt_state, jax_batch,
                          make_batch, np_f32, ref_params_and_copy,
                          smoke_archs, torch_batch)

# |Δloss| and parameter bounds of the reference's own drop-in test
# (tests/kernels/test_adalomo_kernel.py::test_pallas_backend_drop_in_trains).
LOSS_TOL = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


def _assert_states_close(port_state, ref_state):
    conv = convert_opt_state(ref_state)
    assert int(port_state.step) == int(conv.step)
    for (kp, a), (_, b) in zip(tree_flatten_with_path(port_state.moments),
                               tree_flatten_with_path(conv.moments)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_allclose(np_f32(x), np_f32(y), rtol=1e-4,
                                           atol=1e-7, err_msg="/".join(kp))


def _run_both(name, n_steps=2, hparams=1e-3, ggn=None, ref_kw=None,
              port_kw=None, groups=False, **variant):
    ref_arch, port_arch = smoke_archs(**variant)
    ref_params, port_params = ref_params_and_copy(ref_arch)
    batch = make_batch(ref_arch.cfg.vocab, 2, 16)
    ropt = ref_opt.get_opt(name, groups=(ref_no_decay_1d(),) if groups else (),
                           **(ref_kw or {}))
    popt = opt_lib.get_opt(name, groups=(no_decay_1d(),) if groups else (),
                           **(port_kw or {}))
    rstep = jax.jit(lambda p, s, b: ref_arch.make_fused_train_step(
        ropt, global_grad_norm=ggn)(p, s, b, hparams=hparams))
    pstep = port_arch.make_fused_train_step(popt, global_grad_norm=ggn)
    rp, rs = ref_params, ropt.init(ref_params)
    pp, ps = port_params, popt.init(port_params)
    for _ in range(n_steps):
        rp, rs, rloss, rmetrics = rstep(rp, rs, jax_batch(batch))
        out, ps, ploss, pmetrics = pstep(pp, ps, torch_batch(batch),
                                         hparams=hparams)
        assert out is pp                                       # in place
        assert abs(float(ploss) - float(rloss)) < LOSS_TOL
        for k in rmetrics:
            np.testing.assert_allclose(float(pmetrics[k]), float(rmetrics[k]),
                                       rtol=1e-4, atol=1e-6)
    assert_trees_close(pp, rp, what=name, **PARAM_TOL)
    _assert_states_close(ps, rs)
    return pp, ps


def test_two_fused_adalomo_steps_match_reference():
    _run_both("adalomo", ref_kw={"backend": "jnp"},
              port_kw={"backend": "torch"})


def test_fused_adalomo_matches_reference_pallas_backend():
    """The port's op path on the CPU (backend="auto": plain versions of the
    kernels' arithmetic through ``update_tensor``) against the reference run
    through its Pallas kernels in interpret mode."""
    _run_both("adalomo", ref_kw={"backend": "pallas", "interpret": True,
                                 "block": (128, 256)})


@pytest.mark.parametrize("variant", [
    {"tie_embeddings": True}, {"qk_norm": True, "z_loss": 1e-3}])
def test_fused_adalomo_variants_match_reference(variant):
    """Tied embeddings: ``outer`` is updated once, from the sum of the
    epilogue's and the prologue's gradients."""
    _run_both("adalomo", **variant)


def test_fused_with_groups_and_weight_decay_matches_reference():
    _run_both("adalomo", groups=True,
              hparams={"lr": 1e-3, "weight_decay": 0.1,
                       "groups": {"no_decay": {"lr": 5e-4}}})


def test_lomo_fused_sgd_matches_reference():
    _run_both("lomo", hparams=1e-2)


def test_global_grad_norm_two_pass_matches_reference():
    """A threshold far below the gradient norm, so the clip is active."""
    _run_both("lomo", hparams=1e-2, ggn=0.05)
    _run_both("adalomo", hparams=1e-3, ggn=0.05, n_steps=1)


def test_fused_equals_unfused_within_port():
    """One fused step == grads of ``unfused_loss_fn`` + ``Opt.step`` at the
    same weights (the same rule over the same state layout)."""
    ref_arch, port_arch = smoke_archs()
    _, p_fused = ref_params_and_copy(ref_arch)
    _, p_unfused = ref_params_and_copy(ref_arch)
    batch = torch_batch(make_batch(ref_arch.cfg.vocab, 2, 16))
    opt = opt_lib.get_opt("adalomo", groups=(no_decay_1d(),))
    hp = {"lr": 1e-3, "weight_decay": 0.05}

    s_fused = opt.init(p_fused)
    _, s_fused, loss_f, _ = port_arch.make_fused_train_step(opt)(
        p_fused, s_fused, batch, hparams=hp)

    p_req = tree_map(lambda t: t.detach().requires_grad_(True), p_unfused)
    loss_u, _ = port_arch.make_loss_fn()(p_req, batch)
    leaves = tree_leaves(p_req)
    it = iter(torch.autograd.grad(loss_u, leaves))
    grads = tree_map(lambda _: next(it), p_req)
    s_unfused = opt.init(p_unfused)
    _, s_unfused = opt.step(p_unfused, grads, s_unfused, hp)

    assert abs(float(loss_f) - float(loss_u.detach())) < 1e-6
    for (kp, a), (_, b) in zip(tree_flatten_with_path(p_fused),
                               tree_flatten_with_path(p_unfused)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg="/".join(kp))
    assert int(s_fused.step) == int(s_unfused.step) == 1


def test_stack_grads_equal_autograd_of_whole_model():
    """``stack_forward`` + ``stack_grads`` (per-layer remat) give the
    gradients of the whole model's autograd."""
    ref_arch, port_arch = smoke_archs()
    _, params = ref_params_and_copy(ref_arch)
    batch = torch_batch(make_batch(ref_arch.cfg.vocab, 2, 16))
    spec = make_fused_spec(port_arch.cfg)
    body = spec.bodies["blocks"]
    stacked = params["stacks"]["blocks"]
    ctx = ({}, spec.pro_ctx(params["outer"], batch))
    with torch.no_grad():
        x0 = spec.prologue(params["outer"], batch)
        res = fused.stack_forward(body, stacked, ctx, x0)
    assert len(res.saved_x) == port_arch.cfg.n_layers
    xo = tuple(t.detach().requires_grad_(True) for t in res.x_out)
    loss, _ = spec.epilogue(params["outer"], xo, batch)
    dx = torch.autograd.grad(loss, xo)
    _, _, g_stack = fused.stack_grads(body, stacked, ctx, res, dx)

    p_req = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss_u, _ = fused.unfused_loss_fn(spec, p_req, batch)
    want = torch.autograd.grad(loss_u, tree_leaves(p_req["stacks"]["blocks"]))
    for a, b in zip(tree_leaves(g_stack), want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)


def test_fused_step_leaves_no_grad_fields_and_no_graph():
    ref_arch, port_arch = smoke_archs()
    _, params = ref_params_and_copy(ref_arch)
    opt = opt_lib.get_opt("adalomo")
    state = opt.init(params)
    _, state, loss, metrics = port_arch.make_fused_train_step(opt)(
        params, state, torch_batch(make_batch(ref_arch.cfg.vocab, 2, 16)),
        hparams=1e-3)
    assert all(t.grad is None and not t.requires_grad
               for t in tree_leaves(params))
    assert not loss.requires_grad
    assert all(not v.requires_grad for v in metrics.values())
    assert ref_make_fused_spec(ref_arch.cfg)._fields == \
        make_fused_spec(port_arch.cfg)._fields
