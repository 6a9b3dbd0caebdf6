"""The port's kernel roofline counters (``repro_torch.telemetry.kernels``)
against the JAX package's (``repro.telemetry.kernels``): the same FLOPs,
bytes, intensity and stream record, number for number, over a grid of
shapes and item sizes; the same registry, lookup error and zoo cases.
Pure arithmetic: nothing is allocated."""
import itertools
import os
import subprocess
import sys

import pytest

from repro.telemetry import kernels as ref_K
from repro_torch.telemetry import kernels as K

HERE = os.path.dirname(__file__)
ROOT = os.path.join(HERE, os.pardir)

# (m, n): a 1x1 matrix, smoke widths, danube's leaves, whisper-base's tied
# head, paligemma-3b's tied head
MATRICES = [(1, 1), (16, 24), (2560, 640), (6912, 2560), (51865, 512),
            (257216, 2048)]
# h2o-danube-1.8b's matrices, how many a train step updates (170)
DANUBE_MATRICES = {(2560, 2560): 48, (2560, 640): 48, (2560, 6912): 48,
                   (6912, 2560): 24, (32000, 2560): 1, (2560, 32000): 1}
# (batch, q_heads, kv_heads, head_dim, seq_len, page_size, pages_per_seq)
PAGED = [(1, 1, 1, 16, 1, 16, 0), (8, 32, 8, 80, 1024, 16, 0),
         (8, 32, 8, 80, 1000, 16, 0), (8, 32, 8, 80, 1000, 16, 128),
         (128, 32, 8, 128, 32768, 16, 0), (1, 8, 1, 256, 524288, 64, 0)]


def _same(got, want):
    assert type(got).__name__ == type(want).__name__ == "KernelCounters"
    for field in ("kernel", "flops", "bytes", "shape", "note", "intensity"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.record(step=3, backend="cuda") == want.record(
        step=3, backend="cuda")


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("m,n", MATRICES)
def test_adalomo_update_counters_match_reference(m, n, itemsize):
    """K1 + K2's counts for one matrix and for stacks of 6 and 24."""
    for stacks in (1, 6, 24):
        _same(K.adalomo_update_counters(m, n, stacks=stacks,
                                        itemsize=itemsize),
              ref_K.adalomo_update_counters(m, n, stacks=stacks,
                                            itemsize=itemsize))


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("case", PAGED)
def test_paged_decode_attention_counters_match_reference(case, itemsize):
    """K3's counts: whole pages touched (or a fixed grid of them), GQA's
    pages shared across the query heads of a group."""
    B, H, Kh, dh, S, ps, pps = case
    kw = dict(page_size=ps, pages_per_seq=pps, itemsize=itemsize)
    _same(K.paged_decode_attention_counters(B, H, Kh, dh, S, **kw),
          ref_K.paged_decode_attention_counters(B, H, Kh, dh, S, **kw))


def test_registry_lookup_and_its_error_match_reference():
    """The same kernels registered; ``counters_for`` evaluates each at a
    shape as its counter function does; an unknown kernel raises the same
    ``KeyError``."""
    assert sorted(K.REGISTRY) == sorted(ref_K.REGISTRY)
    shapes = {"adalomo_update": dict(m=4096, n=11008, itemsize=2),
              "paged_decode_attention": dict(
                  batch=4, q_heads=8, kv_heads=8, head_dim=64,
                  seq_len=448, pages_per_seq=32)}
    for name, shape in shapes.items():
        _same(K.counters_for(name, **shape),
              ref_K.counters_for(name, **shape))
    for name in ("decode_attention", "adalomo_stats", ""):
        with pytest.raises(KeyError) as got:
            K.counters_for(name)
        with pytest.raises(KeyError) as want:
            ref_K.counters_for(name)
        assert str(got.value) == str(want.value)


def test_zoo_cases_match_reference():
    """The analytic zoo rows from each package's own ``SHAPES`` table,
    and each row's counters."""
    got, want = K.zoo_cases(), ref_K.zoo_cases()
    assert got == want
    for (name, shape, _), (rname, rshape, _) in zip(got, want):
        _same(K.counters_for(name, **shape),
              ref_K.counters_for(rname, **rshape))


def test_intensity_guards_a_zero_byte_count():
    """``intensity`` divides by at least one byte, as the reference's."""
    for flops, nbytes in itertools.product((0.0, 7.0), (0.0, 0.5, 3.0)):
        got = K.KernelCounters("k", flops, nbytes, {})
        want = ref_K.KernelCounters("k", flops, nbytes, {})
        assert got.intensity == want.intensity


def test_counter_bounds_script_prints_its_table():
    """``scripts/torch_counter_bounds.py`` (the table of the registry's
    bytes beside ``chip_smoke.py``'s bound bytes) runs on the CPU and its
    registry column is the counters' own."""
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts",
                                      "torch_counter_bounds.py")],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    rows = {line.split("|")[1].strip(): line for line in
            proc.stdout.splitlines() if line.startswith("| K")}
    assert set(rows) == {"K1 + K2", "K3"}
    danube = sum(count * K.adalomo_update_counters(m, n, itemsize=2).bytes
                 for (m, n), count in DANUBE_MATRICES.items())
    assert f"{danube:,.0f}" in rows["K1 + K2"]
