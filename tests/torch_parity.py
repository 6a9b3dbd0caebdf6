"""Helpers shared by the tests of the PyTorch port (``tests/test_torch_*.py``).

The tests feed the same numpy-made inputs to the JAX package (``repro``) and
to the port (``repro_torch``) and compare the results as numpy arrays.  Only
the tests import both packages; the port imports neither ``jax`` nor
``repro``.
"""
import dataclasses

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


def smoke_archs(**overrides):
    """The danube smoke config in both packages, with the same overrides."""
    ref = ref_get_arch(ARCH_ID, smoke=True)
    port = port_get_arch(ARCH_ID, smoke=True)
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


def make_batch(vocab: int, batch: int, seq: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (batch, seq)).astype(np.int32),
            "labels": rng.integers(0, vocab, (batch, seq)).astype(np.int32)}


def jax_batch(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


__all__ = ["CPU", "ARCH_ID", "np_f32", "jax_flat", "port_flat",
           "assert_trees_close", "smoke_archs", "tiny_llama_archs",
           "ref_params_and_copy",
           "convert_opt_state", "make_batch", "jax_batch", "torch_batch",
           "to_numpy"]
