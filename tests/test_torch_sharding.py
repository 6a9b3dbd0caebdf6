"""The port's partition rules and activation policy against the JAX
package's, and the plain sharded AdaLomo update against the reference's
single-device one.  In process: no world is formed.

The rules are fed the same paths and shapes in both packages, from
``jax.eval_shape`` of the reference's init (nothing is allocated), on the
production layouts 16 x 16 and 2 x 16 x 16 and on (4, 2).  The reference's
``MeshAxes`` gets a stand-in mesh with ``axis_names`` and ``shape``, all it
reads."""
import re
import threading

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
from repro_torch.kernels.adalomo_update.ref import (adalomo_update_grid,
                                                    adalomo_update_shards)
from repro_torch.launch.mesh import (MeshLayout, make_production_mesh,
                                     make_test_mesh)
from repro_torch.core.tree import (pytree_leaves, tree_flatten_with_path,
                                   tree_map)
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
    """The model-axis policy (the guard of slice 6b, which it no longer
    raises) against the reference's: ``shard_act`` of every kind gives the
    reference's values (its constraint is the identity on values; with no
    world the port's tile is the whole activation, and ``kv_full``'s
    gather over the model ranks is tested in ``test_torch_model_axis.py``),
    ``seq_tiles`` the reference's count, and with no policy the batch sums
    and means are identities."""
    mesh = MeshLayout((2, 2), ("data", "model"))
    ref_pol = ref_act.ActPolicy(StandIn(mesh),
                                ref_rules.MeshAxes(StandIn(mesh)))
    x = torch.arange(2 * 4 * 8, dtype=torch.float32).reshape(2, 4, 8)
    with act.use_policy(act.ActPolicy(mesh, rules.MeshAxes(mesh))):
        for kind in KINDS:
            assert torch.equal(act.shard_act(x, kind),
                               torch.from_numpy(np.asarray(
                                   ref_act.shard_act(x.numpy(), kind))))
        with ref_act.use_policy(ref_pol):
            for n in (64, 63, 2):
                assert act.seq_tiles(n) == ref_act.seq_tiles(n)
        # a layout, no world: no model group, so one tile, the whole
        assert act.seq_offset(16) == 0 and act.model_size() == 1
    assert act.current_policy() is None
    x = torch.zeros(2, 3)
    assert act.shard_act(x, "kv_full") is x and act.seq_tiles(64) == 1
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


# --------------------------------------------------------------------------
# 2-D blocks (the model axis): R x C grids of [3, m, n], each block's sums
# over the other row and column blocks emulated in one process
# --------------------------------------------------------------------------

class _Group:
    """A group of threads whose ``all_reduce`` is the collectives' (the
    members' tensors widened to fp32 and added in member order, narrowed
    once), so that ``update_tensor_sharded`` runs per block as on a rank."""

    def __init__(self, n):
        self.bar = threading.Barrier(n)
        self.buf = [None] * n

    def all_reduce(self, idx, t):
        self.buf[idx] = t
        self.bar.wait()
        out = self.buf[0].to(torch.float32, copy=True)
        for x in self.buf[1:]:
            out += x
        self.bar.wait()
        return out.to(t.dtype)


class _BlockShard:
    """``sharding.zero.TensorShard``'s interface for block (i, j) of an
    R x C grid of thread groups."""

    def __init__(self, rows, cols, both, i, j, C, n_total):
        self.rows, self.cols, self.both = rows, cols, both
        self.i, self.j, self.C, self.n_total = i, j, C, n_total

    @property
    def axis(self):
        if self.cols is None:
            return -2
        return -1 if self.rows is None else 0

    def sum(self, t):
        return self.both.all_reduce(self.i * self.C + self.j, t)

    def over_rows(self, t):
        return t if self.rows is None else self.rows.all_reduce(self.i, t)

    def over_cols(self, t):
        return t if self.cols is None else self.cols.all_reduce(self.j, t)


def _grid_blocks(x, R, C):
    """[.., m, n] -> R x C contiguous blocks."""
    return [[b.contiguous() for b in rows.chunk(C, dim=-1)]
            for rows in x.chunk(R, dim=-2)]


def _grid_plain(p, g, r, c, R, C, *, lr, step, wd):
    """``core.adalomo.update_tensor_sharded`` on each block of an R x C
    grid, one thread a block; the blocks put back together."""
    from repro_torch.core.adalomo import FactoredState, update_tensor_sharded
    P, Gr = _grid_blocks(_torch(p), R, C), _grid_blocks(_torch(g), R, C)
    rs = list(_torch(r).chunk(R, dim=-1))
    cs = list(_torch(c).chunk(C, dim=-1))
    m, n = p.shape[-2:]
    col_groups = [_Group(C) for _ in range(R)] if C > 1 else [None] * R
    row_groups = [_Group(R) for _ in range(C)] if R > 1 else [None] * C
    both = _Group(R * C)
    out = {}

    def one(i, j):
        shard = _BlockShard(row_groups[j], col_groups[i], both, i, j, C,
                            m * n)
        out[i, j] = update_tensor_sharded(
            P[i][j], Gr[i][j], FactoredState(r=rs[i], c=cs[j], v=None),
            lr=lr, step=step, weight_decay=wd, cfg=AdaLomoConfig(),
            shard=shard)

    threads = [threading.Thread(target=one, args=(i, j))
               for i in range(R) for j in range(C)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(R):          # every block of a row folds the same r
        for j in range(1, C):
            assert torch.equal(out[i, j][1].r, out[i, 0][1].r)
    new_p = torch.cat([torch.cat([out[i, j][0] for j in range(C)], -1)
                       for i in range(R)], -2)
    return (new_p, torch.cat([out[i, 0][1].r for i in range(R)], -1),
            torch.cat([out[0, j][1].c for j in range(C)], -1))


def _grid_kernels_plain(p, g, r, c, R, C, *, lr, step, wd):
    """K1 mode 3's and K2's sharded entries' plain versions on each block
    (``ref.adalomo_update_grid``); the blocks put back together."""
    P, Gr = _grid_blocks(_torch(p), R, C), _grid_blocks(_torch(g), R, C)
    rs = [[t.clone() for _ in range(C)] for t in _torch(r).chunk(R, -1)]
    cs = [[t.clone() for t in _torch(c).chunk(C, -1)] for _ in range(R)]
    adalomo_update_grid(P, Gr, rs, cs, lr=lr, step=step, weight_decay=wd,
                        plain=True)
    return (torch.cat([torch.cat(row, -1) for row in P], -2),
            torch.cat([row[0] for row in rs], -1),
            torch.cat(cs[0], -1))


@pytest.mark.parametrize("impl", ["update_tensor_sharded", "k1_mode3"])
@pytest.mark.parametrize("grid", [(2, 2), (1, 2)])
@pytest.mark.parametrize("shape", [(64, 128), (96, 300)])   # 300: ragged
@pytest.mark.parametrize("pdt", [jnp.float32, jnp.bfloat16])
def test_2d_block_update_matches_reference(shape, grid, impl, pdt):
    """A tensor split into an R x C grid of blocks (2 x 2: rows over data,
    columns over model; 1 x 2: columns only), updated block by block with
    the sums over the other row and column blocks: against the reference's
    ``update_tensor`` on the whole tensor."""
    m, n = shape
    R, C = grid
    fn = _grid_plain if impl == "update_tensor_sharded" else \
        _grid_kernels_plain
    for step, wd in ((1.0, 0.0), (5.0, 0.01)):
        p, g, r, c = _inputs(m, n, pdt, step, seed=m + n + R)
        pk, rk, ck = fn(p, g, r, c, R, C, lr=5e-4, step=step, wd=wd)
        pr, rr, cr = _reference(p, g, r, c, lr=5e-4, step=step, wd=wd)
        tol = 1e-5 if pdt == jnp.float32 else 5e-3
        np.testing.assert_allclose(_np(pk), np.asarray(pr, np.float32),
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(_np(rk), np.asarray(rr), rtol=3e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(_np(ck), np.asarray(cr), rtol=3e-5,
                                   atol=1e-5)


def test_single_axis_grid_keeps_the_single_axis_bits():
    """K1 mode 3's path on a 2 x 1 and a 1 x 2 grid (one way split) gives
    the bits of the single-axis entries (modes 1 and 2) on the same
    shards, plain versions both."""
    p, g, r, c = _inputs(96, 160, jnp.bfloat16, 5.0, seed=4)
    kw = dict(lr=5e-4, step=5.0, wd=0.01)
    for grid, axis in (((2, 1), -2), ((1, 2), -1)):
        a = _grid_kernels_plain(p, g, r, c, *grid, **kw)
        b = _sharded(p, g, r, c, 2, axis, plain=True, **kw)
        for x, y in zip(a, b):
            assert torch.equal(x, y), grid


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_zero3_places_match_reference_specs(arch_id):
    """``sharding.zero``'s 2-D places of every config at full width on
    (4, 2) against the reference's ``param_pspecs``: the data dim and the
    model dim of each leaf, the expert stacks' model split kept at use;
    and each factored state's places against the reference's
    ``opt_pspecs`` (r the param's row split, c its column split) wherever
    the reference's shape table is unambiguous (two params of one shape
    but other specs share its entry there)."""
    from repro_torch.sharding.zero import leaf_places, param_places
    _, abstract = _abstract(arch_id)
    mesh = LAYOUTS["4x2"]
    ref_axes, axes = ref_rules.MeshAxes(StandIn(mesh)), rules.MeshAxes(mesh)
    params = _meta(abstract)
    ref_p = ref_rules.param_pspecs(abstract, ref_axes)
    places = param_places(params, axes)

    def dim_of(spec, name):
        for i, a in enumerate(spec):
            if a == name or (isinstance(a, tuple) and name in a):
                return i
        return None

    got = [pl for _, pl in tree_flatten_with_path(places)]
    ref_leaves = _ref_specs(ref_p)
    paths = [("/".join(kp)) for kp, _ in tree_flatten_with_path(places)]
    assert len(got) == len(ref_leaves)
    for path, pl, spec in zip(paths, got, ref_leaves):
        assert (pl.data, pl.model) == (dim_of(spec, "data"),
                                       dim_of(spec, "model")), path
        assert pl.ep == (pl.model is not None and bool(re.search(
            r"moe/w_(gate|up|down)", path))), path
    state = get_opt("adalomo").init(params)
    shapes = tree_map(lambda t: tuple(t.shape), params)
    o_places = leaf_places(places, shapes, state)[len(got) + 1:]
    ref_o = _ref_specs(ref_rules.opt_pspecs(
        jax.eval_shape(ref_get_opt("adalomo").init, abstract), abstract,
        ref_p, ref_axes))
    by_shape = {}
    for leaf, spec in zip(pytree_leaves(params), ref_leaves):
        by_shape.setdefault(tuple(leaf.shape), set()).add(spec)
    ambiguous = {shp for shp, specs in by_shape.items() if len(specs) > 1}
    compared = 0
    for t, pl, spec in zip(pytree_leaves(state.moments), o_places,
                           ref_o[1:]):                  # after the step
        sh = tuple(t.shape)
        near = [s for s in by_shape if s == sh or s[:-1] == sh
                or s[:-2] + s[-1:] == sh]
        if any(s in ambiguous for s in near) or len(near) != 1:
            continue
        compared += 1
        assert (pl.data, pl.model) == (dim_of(spec, "data"),
                                       dim_of(spec, "model")), sh
    assert compared > 0


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


@pytest.mark.parametrize("arch_id,layout", [("mamba2-1.3b", (2, 2)),
                                            ("paligemma-3b", (1, 2)),
                                            ("whisper-base", (1, 2))])
def test_program_shardings_on_a_model_axis_as_the_step_rests_them(arch_id,
                                                                  layout):
    """``program_shardings`` on a (data, model) layout: each param spec
    names the dims its resting place splits (``zero.rest_places``, which
    ``Zero3`` rests by: mamba2's per-layer ``conv_b``, which the rules split
    over ``model``, whole; a data axis of 1 splitting nothing), its state
    with it, and the batch's specs the reference's ``batch_pspecs`` on the
    same layout (the leading dim over the batch axes; the model axis'
    tiles, paligemma's prefix with its tokens and whisper's frames apart
    from them, are ``Zero3.rows``'s and no spec's)."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.fleet.elastic import program_shardings
    from repro_torch.run import ModelSpec, OptSpec, RunSpec, StepSpec
    from repro_torch.run.program import build_step_program
    from repro_torch.sharding.zero import leaf_places, rest_places
    spec = RunSpec(model=ModelSpec(arch_id, smoke=True),
                   data=DataConfig(vocab=0, seq_len=16, global_batch=8),
                   opt=OptSpec(name="adalomo"), steps=StepSpec(total=1))
    program = build_step_program(spec, device="cpu")
    mesh = MeshLayout(layout, ("data", "model"))
    p, o, b, _ = program_shardings(program, mesh)
    meta = program.arch.init_params(0, device="meta")
    places = rest_places(meta, rules.MeshAxes(mesh))

    def named(sp, pl):
        return tuple("data" if i == pl.data else "model" if i == pl.model
                     else None for i in range(len(sp)))

    got = tree_flatten_with_path(p)
    rest = [pl for _, pl in tree_flatten_with_path(places)]
    assert [path for path, _ in got] == [
        path for path, _ in tree_flatten_with_path(meta)]
    for (path, sp), pl in zip(got, rest):
        assert tuple(sp) == named(sp, pl), path
    if layout[0] == 1:
        assert not any("data" in sp for _, sp in got)
    state = program.opt.init(meta)
    o_places = leaf_places(places, tree_map(lambda t: tuple(t.shape), meta),
                           state)[len(got):]
    o_specs = _port_specs(o)
    assert len(o_specs) == len(o_places)
    for sp, pl in zip(o_specs, o_places):
        assert sp == named(sp, pl)
    split = [sp for _, sp in got if "model" in sp]
    assert split
    if arch_id == "mamba2-1.3b":
        conv_b = dict(got)[("stacks", "blocks", "conv_b")]
        assert "model" not in conv_b
        assert "model" in rules.param_pspecs(meta, rules.MeshAxes(mesh))[
            "stacks"]["blocks"]["conv_b"]
    d = spec.data
    shapes = program.arch.train_batch_specs(d.global_batch, d.seq_len)
    if arch_id == "whisper-base":
        assert shapes["frames"][0] == (8, 24, 64)
    ref_b = ref_rules.batch_pspecs(
        {k: jax.ShapeDtypeStruct(shp, jnp.float32)
         for k, (shp, _) in shapes.items()},
        ref_rules.MeshAxes(StandIn(mesh)))
    assert sorted(b) == sorted(ref_b)
    for k in b:
        assert tuple(b[k]) == tuple(ref_b[k]), k


@pytest.mark.parametrize("layout", [(2,), (2, 2)], ids=["2", "2x2"])
@pytest.mark.parametrize("opt", ["adamw", "sgd_momentum", "sgd_variance"])
def test_unfused_state_places_match_reference_opt_pspecs(opt, layout):
    """The places of the unfused rules' state (``AdamState`` m and v,
    ``MomentumState`` m, ``VarianceState`` v: each its param's shape) on
    smoke danube at (2,) and (2, 2) against the reference's
    ``opt_pspecs``: each moment rests split as its param, wherever the
    reference's table of shapes is unambiguous (two params of one shape
    but other specs share its entry there)."""
    from repro_torch.sharding.zero import leaf_places, param_places
    arch = ref_get_arch("h2o-danube-1.8b", smoke=True)
    abstract = jax.eval_shape(arch.init_params, jax.random.PRNGKey(0))
    mesh = MeshLayout(layout, ("data", "model")[:len(layout)])
    ref_axes, axes = ref_rules.MeshAxes(StandIn(mesh)), rules.MeshAxes(mesh)
    params = _meta(abstract)
    ref_p = ref_rules.param_pspecs(abstract, ref_axes)
    places = param_places(params, axes)
    state = get_opt(opt).init(params)
    n_p = len(pytree_leaves(params))
    o_places = leaf_places(places, tree_map(lambda t: tuple(t.shape),
                                            params), state)[n_p + 1:]
    ref_o = _ref_specs(ref_rules.opt_pspecs(
        jax.eval_shape(ref_get_opt(opt).init, abstract), abstract, ref_p,
        ref_axes))[1:]                                   # after the step
    by_shape = {}
    for leaf, spec in zip(pytree_leaves(params), _ref_specs(ref_p)):
        by_shape.setdefault(tuple(leaf.shape), set()).add(spec)
    moments = pytree_leaves(state.moments)
    assert len(moments) == len(o_places) == len(ref_o)
    compared = split = 0
    for t, pl, spec in zip(moments, o_places, ref_o):
        if len(by_shape[tuple(t.shape)]) > 1:
            continue
        compared += 1
        split += not pl.whole
        got = tuple("data" if i == pl.data else "model" if i == pl.model
                    else None for i in range(t.ndim))
        assert got == tuple(spec) + (None,) * (t.ndim - len(spec)), t.shape
    assert split > 0 and compared > split
