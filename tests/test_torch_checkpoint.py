"""PyTorch port vs the JAX reference: the checkpoint manager — the same
on-disk format read and written by both packages, the JAX leaf order, the
bf16 payload, crash and corruption handling, async writes, GC and the
preemption marker."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.core.optimizers import get_opt as ref_get_opt
from repro_torch.checkpoint.manager import CheckpointManager, CorruptCheckpoint
from repro_torch.core.adalomo import FactoredState
from repro_torch.core.api import OptState
from repro_torch.core.optimizers import (AdamState, MomentumState,
                                         VarianceState, get_opt)
from repro_torch.core.tree import pytree_leaves, pytree_unflatten
from torch_parity import (CPU, convert_opt_state, np_f32,
                          ref_params_and_copy, smoke_archs)


def _tree():
    return {"w": torch.arange(6.0).reshape(2, 3), "b": torch.zeros((3,))}


def _make_partial(ckpt_dir, step, *, with_manifest=True):
    """Simulate a crash mid-write: a step dir without _COMPLETE."""
    d = ckpt_dir / f"step_{step:09d}"
    d.mkdir(parents=True)
    np.save(d / "arr_00000.npy", np.zeros((2, 3), np.float32))
    if with_manifest:
        (d / "manifest.json").write_text(json.dumps(
            {"step": step, "n_leaves": 1,
             "leaves": [{"file": "arr_00000.npy", "shape": [2, 3],
                         "dtype": "float32"}], "extra": {}}))
    return d


def _leaf_files(d):
    return sorted(d.glob("arr_*.npy"))


def _assert_equal_trees(a, b):
    la, lb = pytree_leaves(a), pytree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ------------------------------------------------ tests/test_checkpoint.py

def test_crash_mid_write_restores_previous_complete_step(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck", async_write=False)
    tree = _tree()
    mgr.save(3, tree)
    _make_partial(mgr.dir, 6)
    (mgr.dir / "_tmp_step_000000009").mkdir()
    assert mgr.latest_step() == 3, "partial step leaked into discovery"
    step, got, _ = mgr.restore(template=tree)
    assert step == 3
    _assert_equal_trees(got, tree)


def test_gc_incomplete_removes_only_orphans(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck", async_write=False)
    tree = _tree()
    mgr.save(3, tree)
    mgr.save(6, tree)
    partial = _make_partial(mgr.dir, 9)
    staging = mgr.dir / "_tmp_step_000000012"
    staging.mkdir()
    removed = mgr.gc_incomplete()
    assert sorted(removed) == ["_tmp_step_000000012", "step_000000009"]
    assert not partial.exists() and not staging.exists()
    assert sorted(mgr._complete_steps()) == [3, 6]
    assert mgr.restore(template=tree)[0] == 6


def test_gc_incomplete_at_construction(tmp_path):
    d = tmp_path / "ck"
    mgr = CheckpointManager(d, async_write=False)
    mgr.save(2, _tree())
    _make_partial(d, 5, with_manifest=False)
    mgr2 = CheckpointManager(d, gc_incomplete=True)
    assert not (d / "step_000000005").exists()
    assert mgr2.latest_step() == 2


def test_restore_with_no_complete_steps_raises(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck", async_write=False)
    _make_partial(mgr.dir, 4)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(template=_tree())


def test_truncated_leaf_falls_back_and_flags(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck", async_write=False)
    tree = _tree()
    mgr.save(3, tree)
    mgr.save(6, tree)
    bad = mgr.dir / "step_000000006"
    leaf = _leaf_files(bad)[0]
    leaf.write_bytes(leaf.read_bytes()[:-16])
    step, got, _ = mgr.restore(template=tree)
    assert step == 3
    _assert_equal_trees(got, tree)
    assert (bad / CheckpointManager.DAMAGED_MARKER).exists()
    assert mgr.latest_step() == 3
    assert "step_000000006" in mgr.gc_incomplete()
    assert not bad.exists()


def test_garbled_leaf_explicit_step_raises_latest_falls_back(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck", async_write=False)
    tree = _tree()
    mgr.save(2, tree)
    mgr.save(4, tree)
    leaf = _leaf_files(mgr.dir / "step_000000004")[0]
    data = bytearray(leaf.read_bytes())
    data[:6] = b"GARBLE"
    leaf.write_bytes(bytes(data))
    with pytest.raises(CorruptCheckpoint):
        mgr.restore(step=4, template=tree)
    assert mgr.restore(template=tree)[0] == 2


def test_every_checkpoint_damaged_raises(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck", async_write=False)
    tree = _tree()
    mgr.save(5, tree)
    _leaf_files(mgr.dir / "step_000000005")[0].unlink()
    with pytest.raises(CorruptCheckpoint, match="damaged"):
        mgr.restore(template=tree)


def test_manifest_without_nbytes_still_restores(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck", async_write=False)
    tree = _tree()
    mgr.save(7, tree)
    mpath = mgr.dir / "step_000000007" / "manifest.json"
    manifest = json.loads(mpath.read_text())
    for leaf in manifest["leaves"]:
        leaf.pop("nbytes")
    mpath.write_text(json.dumps(manifest))
    step, got, _ = mgr.restore(template=tree)
    assert step == 7
    _assert_equal_trees(got, tree)


@pytest.mark.parametrize("change", ["shape", "dtype", "count"])
def test_template_mismatch_raises(tmp_path, change):
    """The template is checked against what the checkpoint holds: leaf
    count (as the reference asserts), shape and dtype."""
    mgr = CheckpointManager(tmp_path / "ck", async_write=False)
    mgr.save(1, _tree())
    bad = {"shape": {"w": torch.zeros(3, 2), "b": torch.zeros(3)},
           "dtype": {"w": torch.zeros(2, 3, dtype=torch.float64),
                     "b": torch.zeros(3)},
           "count": {"w": torch.zeros(2, 3)}}[change]
    with pytest.raises(ValueError):
        mgr.restore(template=bad)
    with pytest.raises(ValueError):
        mgr.restore_into(bad)


# ------------------------------------------------ async writes, GC, marker

def test_async_write_and_keep_last_gc(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck", keep_last=2)
    tree = _tree()
    for step in (1, 2, 3, 4):
        with torch.no_grad():
            tree["w"].add_(1.0)
        mgr.save(step, tree, extra={"data_step": step})
    mgr.wait()
    assert sorted(mgr._complete_steps()) == [3, 4]
    assert not list(mgr.dir.glob("_tmp_step_*"))
    step, got, extra = mgr.restore(template=tree)
    assert step == 4 and extra == {"data_step": 4}
    _assert_equal_trees(got, tree)
    _, older, _ = mgr.restore(step=3, template=tree)
    assert torch.equal(older["w"], tree["w"] - 1.0)
    kinds = [t["kind"] for t in mgr.timings]
    assert kinds.count("save") == 4 and kinds.count("restore") == 2
    assert all(t["write_s"] >= 0 and t["bytes"] == 36
               for t in mgr.timings if t["kind"] == "save")


class _DeferredThread:
    """A writer thread that runs only when joined, so the test mutates the
    tree while the write is certainly still pending."""

    def __init__(self, target, daemon=None):
        self.target = target

    def start(self):
        pass

    def join(self):
        self.target()


def test_save_owns_its_host_copy(tmp_path, monkeypatch):
    """The step updates params in place: a save must hold the values of the
    moment it was called, even while its files are still being written."""
    import types
    from repro_torch.checkpoint import manager as mgr_mod
    monkeypatch.setattr(mgr_mod, "threading",
                        types.SimpleNamespace(Thread=_DeferredThread))
    mgr = CheckpointManager(tmp_path / "ck")
    tree = _tree()
    before = {k: v.clone() for k, v in tree.items()}
    mgr.save(1, tree)
    with torch.no_grad():
        tree["w"].mul_(-3.0).add_(7.0)
        tree["b"].fill_(5.0)
    mgr.wait()
    _, got, _ = mgr.restore(template=tree)
    _assert_equal_trees(got, before)


def test_restore_into_keeps_the_live_tensors(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck", async_write=False)
    params = _tree()
    state = get_opt("adalomo").init(params)
    mgr.save(2, (params, state))
    live = pytree_leaves((params, state))
    snap = [t.clone() for t in live]
    with torch.no_grad():
        for t in live:
            t.add_(1)
    step, extra = mgr.restore_into((params, state))
    assert step == 2 and extra == {}
    after = pytree_leaves((params, state))
    assert all(a is b for a, b in zip(after, live))
    _assert_equal_trees(after, snap)


def test_preempt_marker_round_trip(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck")
    ref = RefManager(tmp_path / "ck")
    assert mgr.read_preempt_marker() is None
    path = mgr.write_preempt_marker(4, signum=15)
    assert path.name == "_PREEMPTED.json" == RefManager.PREEMPT_MARKER
    want = {"step": 4, "resumable": True, "signum": 15}
    assert mgr.read_preempt_marker() == ref.read_preempt_marker() == want
    assert not (mgr.dir / "_PREEMPTED.json.tmp").exists()
    ref.clear_preempt_marker()
    assert mgr.read_preempt_marker() is None
    ref.write_preempt_marker(6, signum=2)
    assert mgr.read_preempt_marker()["step"] == 6
    mgr.clear_preempt_marker()
    mgr.clear_preempt_marker()                  # idempotent
    assert ref.read_preempt_marker() is None


# ------------------------------------------------ JAX leaf order

@pytest.mark.parametrize("name", ["adalomo", "lomo", "sgd"])
def test_leaf_order_is_jax_order(name):
    """(params, OptState) flattens in the order of ``jax.tree_util``:
    factored states give (r, c), unfactored (v), sgd's () nothing."""
    ref_arch, _ = smoke_archs()
    ref_params, params = ref_params_and_copy(ref_arch)
    ref_state = ref_get_opt(name).init(ref_params)
    state = get_opt(name).init(params)
    ref_leaves = jax.tree_util.tree_leaves((ref_params, ref_state))
    leaves = pytree_leaves((params, state))
    assert len(leaves) == len(ref_leaves)
    for a, b in zip(leaves, ref_leaves):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
    # state converted from the reference: the same values, leaf for leaf
    conv = pytree_leaves((params, convert_opt_state(ref_state)))
    for a, b in zip(conv, ref_leaves):
        np.testing.assert_array_equal(np_f32(a), np_f32(b))
    # unflatten rebuilds the structure, None and () in place
    rebuilt = pytree_unflatten((params, state), [t.clone() for t in leaves])
    assert isinstance(rebuilt[1], OptState)
    m = rebuilt[1].moments["outer"]["final_norm"]["scale"]
    if name == "adalomo":
        assert isinstance(m, FactoredState) and m.r is None and m.c is None
        assert m.v.shape == (64,)
    else:
        assert m == ()
    _assert_equal_trees(rebuilt, (params, state))
    with pytest.raises(ValueError):
        pytree_unflatten((params, state), leaves[:-1])


def test_leaf_order_sorts_keys_whatever_the_insertion_order():
    """Dict keys in sorted order, as JAX flattens them, even where the
    dict was built in another order; None and () are no leaves."""
    def tree(v):
        return {"w": v(0), "b": (v(1), None, v(2)),
                "a": {"z": v(3), "c": (), "y": [v(4)]}}

    got = [t.numpy() for t in pytree_leaves(
        tree(lambda i: torch.full((2,), float(i))))]
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        tree(lambda i: jnp.full((2,), float(i))))]
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------ across the two packages

def _ref_and_port_state(name="adalomo"):
    ref_arch, _ = smoke_archs()
    ref_params, params = ref_params_and_copy(ref_arch, seed=4)
    ref_opt = ref_get_opt(name)
    ref_state = ref_opt.init(ref_params)
    # a state with non-zero moments and step: one unfused reference update
    grads = jax.tree.map(lambda p: jnp.cos(p) * 0.01, ref_params)
    ref_params, ref_state = ref_opt.step(ref_params, grads, ref_state, 1e-3)
    from repro_torch.convert import params_from_numpy
    params = params_from_numpy(jax.device_get(ref_params), CPU)
    return (ref_params, ref_state), (params, convert_opt_state(ref_state))


def _manifest(d, step):
    return json.loads((d / f"step_{step:09d}" / "manifest.json").read_text())


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    ref_tree, port_tree = _ref_and_port_state()
    RefManager(tmp_path / "r", async_write=False).save(
        5, ref_tree, extra={"data_step": 5})
    mgr = CheckpointManager(tmp_path / "r")
    template = pytree_unflatten(
        port_tree, [torch.zeros_like(t) for t in pytree_leaves(port_tree)])
    step, got, extra = mgr.restore(template=template)
    assert step == 5 and extra == {"data_step": 5}
    assert int(got[1].step) == 1
    for a, b in zip(pytree_leaves(got), jax.tree_util.tree_leaves(ref_tree)):
        assert a.dtype == (torch.int32 if b.dtype == jnp.int32
                           else torch.float32)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    ref_tree, port_tree = _ref_and_port_state()
    CheckpointManager(tmp_path / "p", async_write=False).save(
        5, port_tree, extra={"data_step": 5})
    RefManager(tmp_path / "r", async_write=False).save(
        5, ref_tree, extra={"data_step": 5})
    # the same format: manifests equal, leaf files byte-equal
    assert _manifest(tmp_path / "p", 5) == _manifest(tmp_path / "r", 5)
    for a, b in zip(_leaf_files(tmp_path / "p" / "step_000000005"),
                    _leaf_files(tmp_path / "r" / "step_000000005")):
        assert a.name == b.name and a.read_bytes() == b.read_bytes()
    step, got, extra = RefManager(tmp_path / "p").restore(template=ref_tree)
    assert step == 5 and extra == {"data_step": 5}
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref_tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bf16_written_by_the_reference_restores_bitwise(tmp_path):
    """The reference writes a bf16 leaf as 2-byte words (``<V2``) with
    manifest dtype "bfloat16"; the port writes the same bytes and restores
    them bitwise as torch.bfloat16."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 5)).astype(np.float32)
    ref_tree = {"w": jnp.asarray(w, jnp.bfloat16),
                "s": jnp.asarray(3, jnp.int32)}
    RefManager(tmp_path / "r", async_write=False).save(2, ref_tree)
    port_tree = {"w": torch.from_numpy(w).to(torch.bfloat16),
                 "s": torch.tensor(3, dtype=torch.int32)}
    CheckpointManager(tmp_path / "p", async_write=False).save(2, port_tree)
    assert _manifest(tmp_path / "p", 2) == _manifest(tmp_path / "r", 2)
    assert _manifest(tmp_path / "r", 2)["leaves"][1]["dtype"] == "bfloat16"
    for a, b in zip(_leaf_files(tmp_path / "p" / "step_000000002"),
                    _leaf_files(tmp_path / "r" / "step_000000002")):
        assert a.read_bytes() == b.read_bytes()
    template = {"w": torch.zeros(4, 5, dtype=torch.bfloat16),
                "s": torch.tensor(0, dtype=torch.int32)}
    for d in ("r", "p"):
        step, got, _ = CheckpointManager(tmp_path / d).restore(
            template=template)
        assert step == 2 and got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"].view(torch.int16),
                           port_tree["w"].view(torch.int16))
        assert torch.equal(got["s"], port_tree["s"])
        np.testing.assert_array_equal(
            got["w"].float().numpy(), np.asarray(ref_tree["w"], np.float32))


# ------------------------------------------------ the baselines' states

@pytest.mark.parametrize("name,cls", [("adamw", AdamState),
                                      ("sgd_momentum", MomentumState),
                                      ("sgd_variance", VarianceState),
                                      ("adafactor", FactoredState)])
def test_baseline_state_leaf_order_is_jax_order(name, cls):
    """The baselines' NamedTuples expand in field order, as JAX flattens
    them (AdamW: m, then v); the same shapes and dtypes leaf for leaf, and
    unflatten rebuilds each state as its own type."""
    ref_arch, _ = smoke_archs()
    ref_params, params = ref_params_and_copy(ref_arch)
    ref_state = ref_get_opt(name).init(ref_params)
    state = get_opt(name).init(params)
    ref_leaves = jax.tree_util.tree_leaves((ref_params, ref_state))
    leaves = pytree_leaves((params, state))
    assert len(leaves) == len(ref_leaves)
    for a, b in zip(leaves, ref_leaves):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
    rebuilt = pytree_unflatten((params, state), [t.clone() for t in leaves])
    m = rebuilt[1].moments["stacks"]["blocks"]["attn"]["wq"]
    assert type(m) is cls
    _assert_equal_trees(rebuilt, (params, state))


def test_adamw_state_crosses_between_the_packages_bitwise(tmp_path):
    """An AdamW ``(params, OptState)`` (fp32 tree, non-zero m and v after
    one reference step) written by the reference restores bitwise in the
    port, each state an ``AdamState`` with m before v; the port writes the
    same manifest and byte-equal files, which the reference restores
    bitwise."""
    ref_tree, port_tree = _ref_and_port_state("adamw")
    RefManager(tmp_path / "r", async_write=False).save(3, ref_tree)
    template = pytree_unflatten(
        port_tree, [torch.zeros_like(t) for t in pytree_leaves(port_tree)])
    step, got, _ = CheckpointManager(tmp_path / "r").restore(
        template=template)
    assert step == 3 and int(got[1].step) == 1
    for a, b in zip(pytree_leaves(got), jax.tree_util.tree_leaves(ref_tree)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ref_head = ref_tree[1].moments["outer"]["head"]
    head = got[1].moments["outer"]["head"]
    assert type(head) is AdamState
    np.testing.assert_array_equal(head.m.numpy(), np.asarray(ref_head.m))
    np.testing.assert_array_equal(head.v.numpy(), np.asarray(ref_head.v))
    assert not np.array_equal(np.asarray(ref_head.m), np.asarray(ref_head.v))

    CheckpointManager(tmp_path / "p", async_write=False).save(3, port_tree)
    assert _manifest(tmp_path / "p", 3) == _manifest(tmp_path / "r", 3)
    for a, b in zip(_leaf_files(tmp_path / "p" / "step_000000003"),
                    _leaf_files(tmp_path / "r" / "step_000000003")):
        assert a.name == b.name and a.read_bytes() == b.read_bytes()
    step, back, _ = RefManager(tmp_path / "p").restore(template=ref_tree)
    assert step == 3
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(ref_tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
