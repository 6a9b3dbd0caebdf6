"""Sequence parallelism in the port's attention (``models/layers.py``): a
rank's tile of the queries, at its absolute positions, against the whole
sequence's K/V (gathered over the model axis) equals the JAX reference's
attention over the whole sequence cut to that tile — forward, and the
gradients of q (the tile's rows) and of k and v (the tile's queries'
share) — in every branch the train path takes: direct, blockwise (the
flash branch's forward), the flash custom VJP with its recomputing
backward, and the sliding-window gather; causal, windowed and packed.  In
process, no world: the gathered K/V is the whole tensor itself."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref_L
from repro_torch.models import layers as L
from torch_parity import patch_attention_thresholds

B, S, K, G, dh = 2, 48, 2, 2, 16
H = K * G
TP = 3                                  # tiles of 16: offsets 0, 16, 32
ROWS = [[12, 20, 16], [30, 10]]         # packed: row 1 ends in padding
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _packed():
    seg = np.zeros((B, S), np.int32)
    pos = np.zeros((B, S), np.int32)
    for b, lens in enumerate(ROWS):
        o = 0
        for j, n in enumerate(lens):
            seg[b, o:o + n] = j + 1
            pos[b, o:o + n] = np.arange(n)
            o += n
    return seg, pos


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    return {n: rng.standard_normal(shape).astype(np.float32) for n, shape in
            (("q", (B, S, H, dh)), ("k", (B, S, K, dh)),
             ("v", (B, S, K, dh)), ("w", (B, S, H, dh)))}


def _reference(x, mask, window, tile):
    """The reference's attention over the whole sequence, and the
    gradients of ``Σ(w · out)`` over the tile's rows only."""
    seg, ppos = _packed()
    spec = ref_L.MaskSpec(causal=True, window=window,
                          segmented=mask == "packed")
    pos = jnp.asarray(ppos) if mask == "packed" else jnp.arange(S)
    kw = dict(spec=spec, q_pos=pos, kv_pos=pos)
    if mask == "packed":
        kw.update(q_seg=jnp.asarray(seg), kv_seg=jnp.asarray(seg))
    sel = np.zeros((1, S, 1, 1), np.float32)
    sel[:, tile] = 1.0
    w = jnp.asarray(x["w"] * sel)

    def f(q, k, v):
        out = ref_L.attention(q, k, v, **kw)
        return jnp.sum(out * w), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                         has_aux=True)(
        jnp.asarray(x["q"]), jnp.asarray(x["k"]), jnp.asarray(x["v"]))
    return np.asarray(out)[:, tile], [np.asarray(g) for g in grads]


def _port(x, mask, window, tile, i, *, grad):
    seg, ppos = _packed()
    n = S // TP
    q = torch.from_numpy(x["q"][:, tile].copy()).requires_grad_(grad)
    k = torch.from_numpy(x["k"]).requires_grad_(grad)
    v = torch.from_numpy(x["v"]).requires_grad_(grad)
    spec = L.MaskSpec(causal=True, window=window, segmented=mask == "packed")
    if mask == "packed":
        pos = torch.from_numpy(ppos)
        kw = dict(q_pos=pos[:, tile], kv_pos=pos,
                  q_seg=torch.from_numpy(seg)[:, tile],
                  kv_seg=torch.from_numpy(seg))
    else:
        pos = torch.arange(S, dtype=torch.int32)
        kw = dict(q_pos=pos[tile], kv_pos=pos)
    with torch.set_grad_enabled(grad):
        out = L.attention(q, k, v, spec=spec, q_offset=i * n, **kw)
    if not grad:
        return out.numpy(), None
    gq, gk, gv = torch.autograd.grad(
        torch.sum(out * torch.from_numpy(x["w"][:, tile].copy())), (q, k, v))
    return out.detach().numpy(), [gq.numpy(), gk.numpy(), gv.numpy()]


@pytest.mark.parametrize("mask,window", [("causal", None), ("window", 7),
                                         ("packed", None)])
@pytest.mark.parametrize("branch", ["direct", "blockwise", "flash"])
def test_tile_attention_matches_whole_sequence(inputs, monkeypatch, branch,
                                               mask, window):
    """Each of the three tiles: the port's tile against the reference's
    whole-sequence attention sliced to it.  ``blockwise`` and ``flash`` run
    with blocks of 8 and the direct threshold at 16 (the flash branch's
    forward alone, and with its custom VJP; a window of 7 takes the window
    gather there, whose windows start at the tile's offset)."""
    if branch != "direct":
        patch_attention_thresholds(monkeypatch, direct=16, block=8)
    n = S // TP
    for i in range(TP):
        tile = slice(i * n, (i + 1) * n)
        want, grads = _reference(inputs, mask, window, tile)
        got, port_grads = _port(inputs, mask, window, tile, i,
                                grad=branch != "blockwise")
        np.testing.assert_allclose(got, want, err_msg=f"tile {i}", **TOL)
        if port_grads is None:
            continue
        gq, gk, gv = port_grads
        np.testing.assert_allclose(gq, grads[0][:, tile],
                                   err_msg=f"dq tile {i}", **GRAD_TOL)
        np.testing.assert_allclose(gk, grads[1], err_msg=f"dk tile {i}",
                                   **GRAD_TOL)
        np.testing.assert_allclose(gv, grads[2], err_msg=f"dv tile {i}",
                                   **GRAD_TOL)


def test_tiles_sum_to_the_whole_kv_gradient(inputs, monkeypatch):
    """dK/dV from the three tiles' queries, summed (what ``kv_full``'s
    backward does over the model ranks), are the whole sequence's."""
    patch_attention_thresholds(monkeypatch, direct=16, block=8)
    n = S // TP
    gk = gv = 0.0
    for i in range(TP):
        _, g = _port(inputs, "causal", None, slice(i * n, (i + 1) * n), i,
                     grad=True)
        gk, gv = gk + g[1], gv + g[2]
    _, grads = _reference(inputs, "causal", None, slice(0, S))
    np.testing.assert_allclose(gk, grads[1], **GRAD_TOL)
    np.testing.assert_allclose(gv, grads[2], **GRAD_TOL)
