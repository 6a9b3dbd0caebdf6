"""bf16 sharded steps: the port's ``(2,)`` gloo world against the JAX
package's ``(2,)`` GSPMD mesh, each held against its own unsharded run.

danube's smoke config in bfloat16 (``dataclasses.replace`` of the smoke
config's dtype), the same weights and batches in both packages, fused
AdaLomo for 4 steps.  For each package the params after steps 2 and 4 are
compared with that package's unsharded bf16 run, and the elements beyond
the reference's sharded tolerance (rtol 5e-4, atol 1e-5) plus one bf16
ulp of the value are counted.  A sharded bf16 step sums the ranks'
partial gradients, each already rounded to bf16 by its own backward, in
another order than one device's backward does, so neither package stays
within that tolerance everywhere; the counts grow with the steps.

Measured on the CPU (of 90 432 elements): the reference 12 after 2 steps
and 61 after 4; the port 1 and 19.  The port's sharded bf16 step stays
closer to its unsharded run than GSPMD's does, so the gap is the
reference's own behaviour, not a fault of the port's rounding: the test
holds both counts within :data:`BOUND` and the port's at most the
reference's."""
import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.optimizers import get_opt
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.run import run
from repro_torch.run.hooks import Hook
from torch_parity import bf16_outside, ref_params_and_copy, smoke_archs
from _torch_elastic_worker import dtype_arch, make_spec, run_world

DANUBE = "h2o-danube-1.8b"
STEPS = (2, 4)
HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, os.pardir, "src")
# The most elements beyond the tolerance either package may leave after
# each step count, of 90 432: twice the reference's measured counts
# (module docstring).
BOUND = {2: 24, 4: 122}


def _f32(tree) -> list:
    return [t.to(torch.float32).numpy() for t in tree_leaves(tree)]


@pytest.fixture(scope="module")
def counts(tmp_path_factory):
    d = tmp_path_factory.mktemp("bf16")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC, HERE, os.environ.get("PYTHONPATH", "")]), JAX_PLATFORMS="cpu")
    ref_proc = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_bf16_reference.py"),
         str(d)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    ref_arch, _ = smoke_archs(DANUBE)
    ref_arch = dataclasses.replace(ref_arch, cfg=dataclasses.replace(
        ref_arch.cfg, dtype=jnp.bfloat16))
    _, port_params = ref_params_and_copy(ref_arch)
    assert torch.bfloat16 in {t.dtype for t in tree_leaves(port_params)}
    init = str(d / "init.pt")
    torch.save(port_params, init)
    ck = d / "W"
    run_world(2, str(d / "store"), [
        dict(kind="run", arch=DANUBE, shape=[2], total=STEPS[-1], every=2,
             ckpt=str(ck), init=init, dtype="bfloat16",
             out=str(d / "W.json"))])

    single = {}

    class Capture(Hook):
        def on_step_end(self, ctx, ev):
            if ev.step + 1 in STEPS:
                single[ev.step + 1] = _f32(ctx.params)

    arch = dtype_arch(DANUBE, torch.bfloat16)
    run(make_spec(DANUBE, total=STEPS[-1]), arch=arch,
        params=tree_map(torch.clone, port_params), hooks=[Capture()],
        device="cpu", log_fn=lambda s: None)
    template = (port_params, get_opt("adalomo").init(port_params))
    port = {s: bf16_outside(_f32(CheckpointManager(str(ck)).restore(
        s, template=template)[1][0]), single[s]) for s in STEPS}
    stdout, stderr = ref_proc.communicate(timeout=300)
    assert ref_proc.returncode == 0, stderr[-3000:]
    ref = json.loads((d / "ref.json").read_text())
    return {"ref": {int(k): v for k, v in ref["outside"].items()},
            "port": port, "elements": ref["elements"],
            "n_port": sum(a.size for a in single[STEPS[0]])}


def test_bf16_counts_within_the_measured_bound(counts):
    """Both packages' counts of params beyond the sharded tolerance, after
    2 and 4 bf16 steps on ``(2,)``, lie within :data:`BOUND`, and the
    port's is at most the reference's: the port's sharded bf16 step loses
    no more than GSPMD's does."""
    print("bf16 (2,) elements outside tolerance", counts)
    assert counts["n_port"] == counts["elements"]
    for s in STEPS:
        assert counts["ref"][s] <= BOUND[s], (s, counts)
        assert counts["port"][s] <= BOUND[s], (s, counts)
        assert counts["port"][s] <= counts["ref"][s], (s, counts)
