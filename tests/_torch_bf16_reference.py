"""The JAX package's side of ``test_torch_sharded_bf16.py`` (and of the
bf16 case of ``test_torch_model_axis_families.py``), run in a subprocess
because the virtual device count is fixed at the first ``import jax``: a
smoke config (danube's by default) in bfloat16, fused AdaLomo for
``STEPS[-1]`` steps on one device and sharded by GSPMD on a ``(2,)`` mesh
(or another two-device mesh), from the same weights (``init_params`` of
``PRNGKey(0)``, as the test's own process draws them for the port).
Writes ``ref.json``: the losses, the element count of the params, and
after each step of ``STEPS`` the count of elements beyond the tolerance of
the sharded run against the unsharded.

    python tests/_torch_bf16_reference.py OUT_DIR [ARCH MESH STEPS [SEQ]]

``MESH`` as ``1x2``, ``STEPS`` as ``2,4``, ``SEQ`` the tokens a row (32
when not given).
"""
import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))

STEPS = (2, 4)


def bf16_arch(arch_id="h2o-danube-1.8b"):
    from repro.models.registry import get_arch
    arch = get_arch(arch_id, smoke=True)
    return dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, dtype=jnp.bfloat16))


def main(out_dir: str, arch_id="h2o-danube-1.8b", mesh=(2,),
         steps=STEPS, seq=32) -> None:
    from repro.data.pipeline import DataConfig
    from repro.run import spec as spec_mod
    from repro.run.hooks import Hook
    from repro.run.runner import run
    from _torch_elastic_worker import make_spec
    from torch_parity import bf16_outside, jax_flat

    arch = bf16_arch(arch_id)
    params = arch.init_params(jax.random.PRNGKey(0))

    class Capture(Hook):
        def __init__(self):
            self.at = {}

        def on_step_end(self, ctx, ev):
            if ev.step + 1 in steps:
                self.at[ev.step + 1] = [a for _, a in jax_flat(ctx.params)]

    got = {}
    for name, shape in (("single", None), ("sharded", mesh)):
        cap = Capture()
        spec = make_spec(arch_id, shape=shape, total=steps[-1],
                         spec_mod=spec_mod, data_cls=DataConfig, seq_len=seq)
        res = run(spec, arch=arch, params=jax.tree.map(jnp.copy, params),
                  hooks=[cap], log_fn=lambda s: None)
        got[name] = (cap.at, res.history["loss"])
    n = sum(a.size for a in got["single"][0][steps[0]])
    out = {"elements": n, "steps": list(steps),
           "loss": {k: v[1] for k, v in got.items()},
           "outside": {str(s): bf16_outside(got["sharded"][0][s],
                                            got["single"][0][s])
                       for s in steps}}
    with open(os.path.join(out_dir, "ref.json"), "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    if len(sys.argv) > 2:
        main(sys.argv[1], sys.argv[2],
             tuple(int(n) for n in sys.argv[3].split("x")),
             tuple(int(n) for n in sys.argv[4].split(",")),
             *(int(n) for n in sys.argv[5:6]))
    else:
        main(sys.argv[1])
