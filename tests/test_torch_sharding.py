"""The port's partition rules and activation policy against the JAX
package's, and the plain sharded AdaLomo update against the reference's
single-device one.  In process: no world is formed.

The rules are fed the same paths and shapes in both packages, from
``jax.eval_shape`` of the reference's init (nothing is allocated), on the
production layouts 16 x 16 and 2 x 16 x 16 and on (4, 2).  The reference's
``MeshAxes`` gets a stand-in mesh with ``axis_names`` and ``shape``, all it
reads."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adalomo as ref_adalomo
from repro.core.optimizers import get_opt as ref_get_opt
from repro.models.registry import ARCH_IDS, get_arch as ref_get_arch
from repro.sharding import act as ref_act
from repro.sharding import rules as ref_rules
from repro_torch.core.adalomo import AdaLomoConfig
from repro_torch.core.optimizers import get_opt
from repro_torch.kernels.adalomo_update.ref import adalomo_update_shards
from repro_torch.launch.mesh import (MeshLayout, make_production_mesh,
                                     make_test_mesh)
from repro_torch.sharding import act, rules

LAYOUTS = {"16x16": make_production_mesh(),
           "2x16x16": make_production_mesh(multi_pod=True),
           "4x2": MeshLayout((4, 2), ("data", "model"))}


class StandIn:
    """What the reference's MeshAxes and ActPolicy read of a mesh."""

    def __init__(self, layout):
        self.axis_names = layout.axis_names
        self.shape = layout.shape


def _abstract(arch_id):
    arch = ref_get_arch(arch_id)
    return arch, jax.eval_shape(arch.init_params, jax.random.PRNGKey(0))


def _meta(tree):
    """The reference's abstract tree as the port's: nested dicts of meta
    tensors of the same paths and shapes."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty(tuple(tree.shape), device="meta")


def _ref_specs(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


def _port_specs(tree):
    """Specs in JAX's leaf order: dicts by sorted key, tuples (states)
    expanded, a spec a leaf, None no leaf."""
    if tree is None:
        return []
    if isinstance(tree, rules.P):
        return [tuple(tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _port_specs(tree[k])]
    return [x for t in tree for x in _port_specs(t)]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_pspecs_match_reference(arch_id, layout):
    """param, opt, batch and cache specs of every config at full width."""
    ref_arch, abstract = _abstract(arch_id)
    mesh = LAYOUTS[layout]
    ref_axes, axes = ref_rules.MeshAxes(StandIn(mesh)), rules.MeshAxes(mesh)
    params = _meta(abstract)

    ref_p = ref_rules.param_pspecs(abstract, ref_axes)
    port_p = rules.param_pspecs(params, axes)
    assert _port_specs(port_p) == _ref_specs(ref_p)

    ref_o = ref_rules.opt_pspecs(
        jax.eval_shape(ref_get_opt("adalomo").init, abstract), abstract,
        ref_p, ref_axes)
    port_o = rules.opt_pspecs(get_opt("adalomo").init(params), params,
                              port_p, axes)
    assert _port_specs(port_o) == _ref_specs(ref_o)

    for B in (1, 8, 6):
        batch = ref_arch.train_batch_specs(B, 64)
        assert _port_specs(rules.batch_pspecs(_meta(batch), axes)) == \
            _ref_specs(ref_rules.batch_pspecs(batch, ref_axes))

    cache = jax.eval_shape(lambda: ref_arch.init_cache(8, 64))
    assert _port_specs(rules.cache_pspecs(_meta(cache), axes, 8)) == \
        _ref_specs(ref_rules.cache_pspecs(cache, ref_axes, 8))


def test_whisper_vocab_stays_replicated():
    """The shape guard: 51865 divides by no mesh axis, so whisper's tied
    embedding is not sharded along its vocab."""
    _, abstract = _abstract("whisper-base")
    spec = rules.param_pspecs(_meta(abstract),
                              rules.MeshAxes(make_production_mesh()))
    assert spec["outer"]["tok_embed"][0] is None


KINDS = ("hidden", "ffn", "heads", "q_tiled", "kv_full", "vocab", "experts",
         "other")
SHAPES = ((32, 4096, 2560), (16, 16, 8, 64), (1, 4096), (32,),
          (64, 16, 102400), (48, 33, 7))


@pytest.mark.parametrize("layout", sorted(LAYOUTS) + ["1x1", "test8",
                                                      "test8pod"])
def test_act_policy_spec_matches_reference(layout):
    mesh = {"1x1": MeshLayout((1, 1), ("data", "model")),
            "test8": make_test_mesh(8),
            "test8pod": make_test_mesh(8, multi_pod=True)}.get(
        layout, LAYOUTS.get(layout))
    ref_pol = ref_act.ActPolicy(StandIn(mesh),
                                ref_rules.MeshAxes(StandIn(mesh)))
    pol = act.ActPolicy(mesh, rules.MeshAxes(mesh))
    for kind in KINDS:
        for shape in SHAPES:
            x = jax.ShapeDtypeStruct(shape, jnp.float32)
            assert tuple(pol.spec(x, kind)) == \
                tuple(ref_pol.spec(x, kind)), (kind, shape)


def test_model_axis_policy_raises_slice_6b():
    mesh = MeshLayout((2, 2), ("data", "model"))
    with act.use_policy(act.ActPolicy(mesh, rules.MeshAxes(mesh))):
        with pytest.raises(NotImplementedError, match="slice 6b"):
            act.shard_act(torch.zeros(2, 4, 8), "hidden")
    assert act.current_policy() is None
    x = torch.zeros(2, 3)
    assert act.shard_act(x, "hidden") is x and act.seq_tiles(64) == 1
    assert act.batch_sum(x) is x and act.batch_mean(x) is x


# --------------------------------------------------------------------------
# The plain sharded AdaLomo: K1 partial -> fixed-order sum -> fold -> K2
# partials -> sum -> apply, over 2 and 4 shards, against update_tensor
# --------------------------------------------------------------------------

L_STACK = 3


def _inputs(m, n, pdt, step, seed):
    rng = np.random.default_rng(seed)
    p = (rng.standard_normal((L_STACK, m, n)) * 0.1).astype(np.float32)
    g = (rng.standard_normal((L_STACK, m, n)) * 0.3).astype(np.float32)
    r = (rng.uniform(size=(L_STACK, m)) * 1e-2 * (step > 1)).astype(
        np.float32)
    c = (rng.uniform(size=(L_STACK, n)) * 1e-2 * (step > 1)).astype(
        np.float32)
    p = jnp.asarray(p).astype(pdt)
    g = jnp.asarray(g).astype(pdt)
    return p, g, jnp.asarray(r), jnp.asarray(c)


def _torch(x):
    x = jnp.asarray(x)
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(x.astype(jnp.float32))).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _np(t):
    return t.to(torch.float32).numpy()


def _sharded(p, g, r, c, w, axis, *, lr, step, wd, clip=1.0,
             n_total=None, plain=False):
    """Split [L, m, n] into w shards along ``axis`` (-2 rows, -1 columns),
    run the plain sharded update, and put the shards back together."""
    P, G = _torch(p), _torch(g)
    R, C = _torch(r), _torch(c)
    ps = [t.contiguous() for t in P.chunk(w, dim=axis)]
    gs = [t.contiguous() for t in G.chunk(w, dim=axis)]
    if axis == -2:
        rs = [t.contiguous() for t in R.chunk(w, dim=-1)]
        cs = [C.clone() for _ in range(w)]
    else:
        rs = [R.clone() for _ in range(w)]
        cs = [t.contiguous() for t in C.chunk(w, dim=-1)]
    adalomo_update_shards(ps, gs, rs, cs, lr=lr, step=step, weight_decay=wd,
                          clip=clip, axis=axis, n_total=n_total, plain=plain)
    new_r = torch.cat(rs, -1) if axis == -2 else rs[0]
    new_c = cs[0] if axis == -2 else torch.cat(cs, -1)
    for t in (cs if axis == -2 else rs)[1:]:
        # the vector every rank folds from the same sum: the same bits
        assert torch.equal(t, (cs if axis == -2 else rs)[0])
    return torch.cat(ps, dim=axis), new_r, new_c


def _reference(p, g, r, c, *, lr, step, wd, clip=1.0):
    cfg = ref_adalomo.AdaLomoConfig()
    outs = [ref_adalomo.update_tensor(
        p[i], g[i], ref_adalomo.FactoredState(r=r[i], c=c[i], v=None),
        lr=lr, step=jnp.float32(step), weight_decay=wd, clip=clip, cfg=cfg)
        for i in range(L_STACK)]
    return (jnp.stack([o[0] for o in outs]),
            jnp.stack([o[1].r for o in outs]),
            jnp.stack([o[1].c for o in outs]))


CASES = [(64, 128), (96, 160), (128, 300)]     # the last: n % 8 != 0


@pytest.mark.parametrize("axis", [-2, -1])
@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("shape", CASES)
@pytest.mark.parametrize("pdt", [jnp.float32, jnp.bfloat16])
def test_plain_sharded_update_matches_reference(shape, w, axis, pdt):
    m, n = shape
    if axis == -1 and n % w:
        n += w - n % w                 # columns split evenly; still ragged
    for step, wd in ((1.0, 0.0), (5.0, 0.01)):
        p, g, r, c = _inputs(m, n, pdt, step, seed=m * 7 + n + w)
        pk, rk, ck = _sharded(p, g, r, c, w, axis, lr=5e-4, step=step, wd=wd)
        pr, rr, cr = _reference(p, g, r, c, lr=5e-4, step=step, wd=wd)
        tol = 1e-5 if pdt == jnp.float32 else 5e-3
        np.testing.assert_allclose(_np(pk), np.asarray(pr, np.float32),
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(_np(rk), np.asarray(rr), rtol=3e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(_np(ck), np.asarray(cr), rtol=3e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("axis", [-2, -1])
def test_shard_element_count_in_place_of_global_fails(axis):
    """RMS(u) and RMS(θ) divide by the whole tensor's m·n: the shard's
    count in its place (the error a per-shard kernel would make) moves the
    update away from the reference's.  (A clip threshold above RMS(u), so
    that the wrong count does not cancel between the two RMS values.)"""
    m, n, w = 64, 128, 4
    p, g, r, c = _inputs(m, n, jnp.float32, 5.0, seed=1)
    shard_mn = m * n // w
    kw = dict(lr=5e-2, step=5.0, wd=0.0, clip=100.0)
    pk, _, _ = _sharded(p, g, r, c, w, axis, n_total=shard_mn, **kw)
    pr, _, _ = _reference(p, g, r, c, **kw)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(_np(pk), np.asarray(pr), rtol=1e-5,
                                   atol=1e-5)
    good, _, _ = _sharded(p, g, r, c, w, axis, **kw)
    np.testing.assert_allclose(_np(good), np.asarray(pr), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("axis", [-2, -1])
def test_plain_entries_are_the_wrappers_cpu_path(axis):
    """``plain=True`` (how the card's check runs the plain versions) gives
    the bits the wrappers give on CPU tensors, in place as they are."""
    p, g, r, c = _inputs(96, 160, jnp.bfloat16, 5.0, seed=3)
    kw = dict(lr=5e-4, step=5.0, wd=0.01)
    for a, b in zip(_sharded(p, g, r, c, 4, axis, **kw),
                    _sharded(p, g, r, c, 4, axis, plain=True, **kw)):
        assert torch.equal(a, b)


def test_cfg_default_matches_reference():
    ref, port = ref_adalomo.AdaLomoConfig(), AdaLomoConfig()
    for k in ("eps_div", "eps_stat", "eps_rms", "min_dim_size_to_factor"):
        assert getattr(ref, k) == getattr(port, k)


def test_program_shardings_place_state_with_its_rows_and_columns():
    """``fleet.elastic.program_shardings`` on a layout (nothing allocated):
    the params' specs are the rules', a factored r follows its param's
    rows and c its columns, the batch splits over the data axis and the
    hparams are whole."""
    from repro_torch.fleet.elastic import program_shardings
    from repro_torch.run import ModelSpec, OptSpec, RunSpec, StepSpec
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.run.program import build_step_program
    spec = RunSpec(model=ModelSpec("h2o-danube-1.8b", smoke=True),
                   data=DataConfig(vocab=0, seq_len=16, global_batch=8),
                   opt=OptSpec(name="adalomo"), steps=StepSpec(total=1))
    program = build_step_program(spec, device="cpu")
    mesh = MeshLayout((4,), ("data",))
    p, o, b, hp = program_shardings(program, mesh)
    axes = rules.MeshAxes(mesh)
    meta = program.arch.init_params(0, device="meta")
    assert _port_specs(p) == _port_specs(rules.param_pspecs(meta, axes))
    blocks = o.moments["stacks"]["blocks"]
    assert p["stacks"]["blocks"]["attn"]["wq"] == rules.P(None, "data", None)
    assert tuple(blocks["attn"]["wq"].r) == (None, "data")     # rows
    assert tuple(blocks["attn"]["wq"].c) == (None, None)
    assert p["stacks"]["blocks"]["attn"]["wo"] == rules.P(None, None, "data")
    assert tuple(blocks["attn"]["wo"].r) == (None, None)
    assert tuple(blocks["attn"]["wo"].c) == (None, "data")     # columns
    assert tuple(o.step) == ()
    assert b["tokens"] == rules.P("data", None)
    assert all(tuple(v) == () for v in hp.values())
    with pytest.raises(ValueError, match="no mesh"):
        program_shardings(program)
