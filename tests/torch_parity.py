"""Helpers shared by the tests of the PyTorch port (``tests/test_torch_*.py``).

The tests feed the same numpy-made inputs to the JAX package (``repro``) and
to the port (``repro_torch``) and compare the results as numpy arrays.  Only
the tests import both packages; the port imports neither ``jax`` nor
``repro``.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models.registry import get_arch as ref_get_arch
from repro_torch.convert import (opt_state_from_numpy, params_from_numpy,
                                 to_numpy)
from repro_torch.core.tree import tree_flatten_with_path
from repro_torch.models.registry import get_arch as port_get_arch

CPU = torch.device("cpu")
ARCH_ID = "h2o-danube-1.8b"


def np_f32(x) -> np.ndarray:
    """A JAX or torch array as float32 numpy (bfloat16 widens exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def jax_flat(tree) -> list:
    """``[(path, float32 array)]`` of a JAX pytree, in JAX's leaf order."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    out = []
    for kp, leaf in flat:
        path = "/".join(str(getattr(k, "key", getattr(k, "name", getattr(
            k, "idx", k)))) for k in kp)
        out.append((path, np_f32(leaf)))
    return out


def port_flat(tree) -> list:
    """``[(path, float32 array)]`` of a port tree of tensors."""
    return [("/".join(kp), np_f32(leaf))
            for kp, leaf in tree_flatten_with_path(tree)]


def assert_trees_close(port_tree, ref_tree, *, rtol, atol, what=""):
    """Same paths in the same order, and close values, leaf for leaf."""
    a, b = port_flat(port_tree), jax_flat(ref_tree)
    assert [p for p, _ in a] == [p for p, _ in b], what
    for (path, x), (_, y) in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {path}")


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 values at ``x`` (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return np.exp2(e - 7)


def bf16_outside(got: list, want: list, *, rtol=5e-4, atol=1e-5) -> int:
    """Elements of the float32 arrays ``got`` beyond ``atol + rtol |b| +
    ulp_bf16(b)`` of ``want``'s ``b``."""
    return int(sum(np.sum(np.abs(a - b) > atol + rtol * np.abs(b)
                          + bf16_ulp(b)) for a, b in zip(got, want)))


def smoke_archs(arch_id: str = ARCH_ID, **overrides):
    """A smoke config (danube's by default) in both packages, with the same
    overrides."""
    ref = ref_get_arch(arch_id, smoke=True)
    port = port_get_arch(arch_id, smoke=True)
    if overrides:
        ref = dataclasses.replace(
            ref, cfg=dataclasses.replace(ref.cfg, **overrides))
        port = dataclasses.replace(
            port, cfg=dataclasses.replace(port.cfg, **overrides))
    return ref, port


def tiny_llama_archs(layers: int = 2, d: int = 64):
    """``benchmarks.common.tiny_llama`` (fp32) in both packages."""
    from benchmarks.common import tiny_llama
    from repro_torch.models.registry import Arch
    from repro_torch.models.transformer import LMConfig
    ref = tiny_llama(layers=layers, d=d)
    fields = {f.name: getattr(ref.cfg, f.name)
              for f in dataclasses.fields(LMConfig) if f.name != "dtype"}
    port = Arch(arch_id=ref.arch_id, family=ref.family,
                cfg=LMConfig(**fields, dtype=torch.float32))
    return ref, port


def ref_params_and_copy(ref_arch, seed: int = 0):
    """Reference params from the reference's init, and the same weights
    converted for the port (independently initialised models are never
    compared: the two generators cannot be matched)."""
    ref_params = ref_arch.init_params(jax.random.PRNGKey(seed))
    port_params = params_from_numpy(jax.device_get(ref_params), CPU)
    return ref_params, port_params


def convert_opt_state(ref_state):
    host = jax.device_get(ref_state)
    return opt_state_from_numpy(host.step, host.moments, CPU)


def patch_attention_thresholds(monkeypatch, direct: int = 16,
                               block: int = 16) -> None:
    """Shrink the direct-attention threshold and the query/KV block sizes in
    both packages, so that tiny sequences take the long-sequence branches
    (the reference is patched for the test, never edited)."""
    from repro.models import layers as ref_layers
    from repro_torch.models import layers as port_layers
    for mod in (ref_layers, port_layers):
        monkeypatch.setattr(mod, "_DIRECT_ATTN_MAX_SEQ", direct)
        monkeypatch.setattr(mod, "_Q_BLOCK", block)
        monkeypatch.setattr(mod, "_KV_BLOCK", block)


def make_batch(vocab: int, batch: int, seq: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (batch, seq)).astype(np.int32),
            "labels": rng.integers(0, vocab, (batch, seq)).astype(np.int32)}


def jax_batch(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


# AdamW and SGD-variance divide by √v̂: an element whose gradient sum is
# within fp32 rounding of 0 in some step (its first step is lr·sign(g))
# moves by up to 2·lr differently under another summation order of the
# gradient over the ranks.  Such elements are counted apart: beyond the
# tolerance but within 2·lr of the reference, at most NEAR_ZERO_MAX of
# them in the model; every other element is held at the tolerance.
NORMALISED = ("adamw", "sgd_variance")
NEAR_ZERO_MAX = 4


def params_close(got, want, what, *, opt=None, lr=1e-3, rtol, atol):
    """Leaf by leaf within ``rtol``/``atol``, under the near-zero-gradient
    rule above for the rules that divide by √v̂."""
    assert [p for p, _ in port_flat(got)] == [p for p, _ in jax_flat(want)]
    apart = {}
    for (path, a), (_, b) in zip(port_flat(got), jax_flat(want)):
        diff = np.abs(a - b)
        bad = diff > atol + rtol * np.abs(b)
        if not bad.any():
            continue
        assert opt in NORMALISED, (what, path, int(bad.sum()))
        assert (diff[bad] <= 2 * lr).all(), (what, path, diff[bad].max())
        apart[path] = [(tuple(int(i) for i in ix), float(diff[tuple(ix)]))
                       for ix in np.argwhere(bad)]
    n = sum(len(v) for v in apart.values())
    print(f"{what}: {n} near-zero-gradient elements beyond the tolerance "
          f"and within 2 lr: {apart}")
    assert n <= NEAR_ZERO_MAX, (what, apart)


def plan_mesh(dims: tuple, rank: int):
    """A ``launch.mesh.ProcessMesh`` of the layout ``dims`` (``(data,
    model)`` or ``(pod, data, model)``) as rank ``rank`` of it would hold
    it, with no world and no groups: enough for a ``Zero3`` plan's places
    and :meth:`~repro_torch.sharding.zero.Zero3.rows`, which communicate
    nothing."""
    from repro_torch.launch.mesh import AXES_BY_NDIM, MeshLayout, ProcessMesh
    names = AXES_BY_NDIM[len(dims)]
    coords = {a: (rank // int(np.prod(dims[i + 1:]))) % dims[i]
              for i, a in enumerate(names)}
    return ProcessMesh(layout=MeshLayout(tuple(dims), names), device=CPU,
                       backend="gloo", device_mesh=None, rank=rank,
                       coords=coords,
                       groups=dict.fromkeys(names + ("batch", "matrix",
                                                     "world")))


__all__ = ["CPU", "ARCH_ID", "np_f32", "jax_flat", "port_flat",
           "assert_trees_close", "params_close", "smoke_archs",
           "tiny_llama_archs",
           "ref_params_and_copy", "patch_attention_thresholds",
           "convert_opt_state", "make_batch", "jax_batch", "torch_batch",
           "to_numpy", "plan_mesh"]


def _combine_states(acc, m, l):
    """n states combined as the kernel's ``combine_states`` orders it: each
    head's maximum M, each state's weight ``e^(m_s - M)``, then the sums in
    state order.  Returns the combined state ``(A, M, L)``."""
    M = m.max(dim=0).values
    w = torch.exp(m - M)
    L = torch.zeros_like(M)
    a = torch.zeros_like(acc[0])
    for s in range(acc.shape[0]):
        L = L + l[s] * w[s]
        a = a + acc[s] * w[s][:, None]
    return a, M, L


def combine_runs_model(acc, m, l, group: int = 8, tree: bool = True):
    """K3's and K4's combine of S run states (``csrc/decode_mma.cuh``'s
    ``finish_wide_run`` and ``combine_runs``) in plain PyTorch, in the
    kernel's order: with ``tree`` (the kernel's ``run_groups`` > 0: the
    wide loop's head dim) and past ``group`` runs, each group of ``group``
    runs is combined into a group state first and the group states are
    combined after; each combine takes the heads' maximum and the states'
    weights first, then sums in order.  ``acc [S, G, dh]`` (unnormalised),
    ``m``, ``l`` ``[S, G]``; a run with no valid slot holds ``m = -1e30,
    l = 0, acc = 0``.  Returns ``(out [G, dh], lse [G])``: ``A / max(L,
    1e-30)`` and ``M + log L``; a head with no valid slot gets 0 and
    -inf."""
    if tree and acc.shape[0] > group:
        states = [_combine_states(acc[i:i + group], m[i:i + group],
                                  l[i:i + group])
                  for i in range(0, acc.shape[0], group)]
        acc, m, l = (torch.stack(x) for x in zip(*states))
    a, M, L = _combine_states(acc, m, l)
    out = a / torch.clamp_min(L, 1e-30)[:, None]
    lse = torch.where(L > 0, M + torch.log(L), torch.full_like(L, -math.inf))
    return out, lse


def run_state_model(q, k, v, valid, scale):
    """One run's state as a block of K3 or K4 leaves it: ``q [G, dh]`` over
    the run's rows ``k, v [n, dh]`` with ``valid [n]`` -> ``(acc [G, dh],
    m [G], l [G])``, unnormalised; the neutral state where no slot is
    valid."""
    G, dh = q.shape
    if not bool(valid.any()):
        return (torch.zeros(G, dh), torch.full((G,), -1e30),
                torch.zeros(G))
    s = (q @ k[valid].T) * scale
    m = s.max(dim=-1).values
    p = torch.exp(s - m[:, None])
    return p @ v[valid], m, p.sum(dim=-1)
