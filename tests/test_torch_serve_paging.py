"""The port's host side of serving: the copied page allocator, block tables
and scheduler (the cases of ``tests/serve/test_paging.py``), the engine's TTL
eviction under a fake clock (``tests/serve/test_ttl.py``), and its serve-gauge
stream (``tests/serve/test_gauges.py``), read back with the **JAX package's**
``repro.telemetry.read_stream`` — which shows that the two formats agree."""
import numpy as np
import pytest

from repro.telemetry import read_stream
from repro_torch.serve.engine import PagedEngine, PagedServeConfig
from repro_torch.serve.paging import (OutOfPages, PageAllocator,
                                      build_block_tables, pages_for)
from repro_torch.serve.scheduler import TIMED_OUT, Request, Scheduler
from torch_parity import CPU, ref_params_and_copy, tiny_llama_archs

PROMPTS = [[5, 17, 23, 9], [101, 44], [7] * 6, [3, 4, 5, 6, 7, 8, 9, 10]]


# --------------------------------------------------------------------------
# allocator, block tables, scheduler
# --------------------------------------------------------------------------

def test_pages_for():
    assert pages_for(0, 16) == 0
    assert pages_for(1, 16) == 1
    assert pages_for(16, 16) == 1
    assert pages_for(17, 16) == 2


def test_allocator_reserves_scratch_page():
    a = PageAllocator(num_pages=8, page_size=16)
    got = a.alloc(7)
    assert sorted(got) == list(range(1, 8))   # page 0 never handed out
    with pytest.raises(OutOfPages):
        a.alloc(1)
    a.free(got)
    assert a.n_free == 7


def test_alloc_is_atomic():
    a = PageAllocator(num_pages=4, page_size=8)
    a.alloc(2)
    before = a.n_free
    with pytest.raises(OutOfPages):
        a.alloc(2)
    assert a.n_free == before


def test_double_free_asserts():
    a = PageAllocator(num_pages=4, page_size=8)
    pages = a.alloc(1)
    a.free(pages)
    with pytest.raises(AssertionError):
        a.free(pages)


def test_block_tables_pad_with_scratch():
    t = build_block_tables([[3, 1], [], [2]], max_pages_per_seq=4)
    np.testing.assert_array_equal(
        t, np.array([[3, 1, 0, 0], [0, 0, 0, 0], [2, 0, 0, 0]], np.int32))


def test_scheduler_admission_gated_on_pages():
    a = PageAllocator(num_pages=4, page_size=8)   # 3 usable pages
    s = Scheduler(n_slots=2, allocator=a, max_pages_per_seq=3)
    s.submit(Request(rid=0, prompt=[1] * 16, max_new_tokens=4))
    s.submit(Request(rid=1, prompt=[1] * 16, max_new_tokens=4))
    r0 = s.admit_next()
    assert r0 is not None and r0.rid == 0 and len(r0.pages) == 2
    assert s.admit_next() is None          # 1 page free < 2 needed
    s.finish(r0)
    assert a.n_free == 3
    r1 = s.admit_next()
    assert r1 is not None and r1.rid == 1


def test_scheduler_preempt_requeues_at_front():
    a = PageAllocator(num_pages=6, page_size=8)
    s = Scheduler(n_slots=2, allocator=a, max_pages_per_seq=5)
    s.submit(Request(rid=0, prompt=[1] * 8, max_new_tokens=30))
    s.submit(Request(rid=1, prompt=[1] * 8, max_new_tokens=30))
    s.admit_next()
    young = s.admit_next()
    young.out = [7, 8]
    victim = s.preempt_latest()
    assert victim is young and victim.pages == [] and victim.slot is None
    assert s.queue[0] is young
    assert young.tokens == [1] * 8 + [7, 8]
    with pytest.raises(ValueError):
        s.submit(Request(rid=2, prompt=[1] * 30, max_new_tokens=30))


def test_submit_rejects_request_larger_than_pool():
    a = PageAllocator(num_pages=4, page_size=8)       # 3 usable pages
    s = Scheduler(n_slots=2, allocator=a, max_pages_per_seq=8)
    with pytest.raises(ValueError, match="pool"):
        s.submit(Request(rid=0, prompt=[1] * 30, max_new_tokens=2))


# --------------------------------------------------------------------------
# the engine: TTL and gauges
# --------------------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def tiny():
    ref, port = tiny_llama_archs(layers=2, d=64)
    return port, ref_params_and_copy(ref, seed=0)[1]


def _engine(tiny, clock=None, **kw):
    port, params = tiny
    base = dict(page_size=8, num_pages=32, max_batch=3, max_pages_per_seq=8,
                chunk=4, max_new_tokens=8, bucket_min=8)
    base.update(kw)
    extra = {"clock": clock} if clock is not None else {}
    return PagedEngine(port, params, PagedServeConfig(**base), device=CPU,
                       **extra)


def test_expired_request_is_evicted_at_chunk_boundary(tiny, tmp_path):
    clock = FakeClock()
    path = tmp_path / "g.jsonl"
    eng = _engine(tiny, clock, telemetry_path=str(path))
    free0 = eng.allocator.n_free
    ra = eng.submit([5, 17, 23, 9], ttl_s=10.0)
    rb = eng.submit([7, 8, 9])                  # no TTL: must finish
    a, b = eng.requests[ra], eng.requests[rb]
    assert a.deadline_s == 10.0 and b.deadline_s is None
    eng.step()
    assert a.status == "running" and len(a.out) > 0
    clock.t = 11.0                              # past A's deadline
    eng.step()
    assert a.status == TIMED_OUT
    assert a.pages == [] and a.slot is None
    partial = list(a.out)
    assert partial
    eng.run()
    assert b.status == "finished" and len(b.out) == 8
    assert a.out == partial
    assert eng.allocator.n_free == free0
    assert eng.scheduler.counters["timed_out"] == 1
    assert eng.scheduler.counters["finished"] == 1
    gauges = read_stream(path).gauges()
    assert gauges[-1]["timed_out"] == 1 and gauges[-1]["running"] == 0


def test_default_ttl_expires_running_and_queued(tiny):
    clock = FakeClock()
    eng = _engine(tiny, clock, max_batch=1, ttl_s=5.0)
    ra = eng.submit([1, 2, 3, 4])
    rb = eng.submit([9, 9, 9])                  # only one slot: stays queued
    eng.step()
    a, b = eng.requests[ra], eng.requests[rb]
    assert a.status == "running" and b.status == "queued"
    clock.t = 6.0
    eng.run()
    assert a.status == TIMED_OUT and a.out
    assert b.status == TIMED_OUT and b.out == []
    assert eng.scheduler.counters["timed_out"] == 2
    assert not eng.scheduler.has_work()


def test_engine_without_path_has_no_telemetry(tiny):
    eng = _engine(tiny)
    assert eng.telemetry is None
    assert len(eng.generate([PROMPTS[0]])[0]) == 8


def test_gauge_stream_matches_engine_bookkeeping(tiny, tmp_path):
    path = tmp_path / "gauges.jsonl"
    eng = _engine(tiny, telemetry_path=str(path))
    outs = eng.generate(PROMPTS)
    assert all(len(o) == 8 for o in outs)
    s = read_stream(path)
    assert s.schema == 1 and s.header == {"schema": 1, "stream": "serve"}
    gauges = s.gauges()
    assert gauges
    for g in gauges:
        assert 0.0 <= g["pool_util"] <= 1.0
        assert 0.0 <= g["block_table_occupancy"] <= 1.0
        assert g["queue_depth"] >= 0 and g["running"] >= 0
        assert g["t_s"] >= 0.0
    assert max(g["pool_util"] for g in gauges) > 0.0
    for key in ("admitted", "finished", "chunks"):
        vals = [g[key] for g in gauges]
        assert vals == sorted(vals)
    last = gauges[-1]
    assert last["admitted"] == eng.scheduler.counters["admitted"] == 4
    assert last["finished"] == eng.scheduler.counters["finished"] == 4
    assert last["prefill_s"] > 0.0 and last["decode_s"] > 0.0
    assert last["chunks"] == eng.telemetry.chunks == eng.chunk_count


def test_run_emits_forced_final_drain_sample(tiny, tmp_path):
    path = tmp_path / "gauges.jsonl"
    eng = _engine(tiny, telemetry_path=str(path), telemetry_every=1000)
    eng.generate(PROMPTS[:2])
    gauges = read_stream(path).gauges()
    assert gauges, "forced drain sample missing"
    assert gauges[-1]["running"] == 0 and gauges[-1]["queue_depth"] == 0
    assert gauges[-1]["pool_util"] == 0.0


def test_telemetry_every_thins_samples(tiny, tmp_path):
    p1, p2 = tmp_path / "every1.jsonl", tmp_path / "every2.jsonl"
    for path, every in ((p1, 1), (p2, 2)):
        _engine(tiny, telemetry_path=str(path),
                telemetry_every=every).generate(PROMPTS)
    dense, thin = read_stream(p1).gauges(), read_stream(p2).gauges()
    assert len(thin) < len(dense)
    assert thin[-1]["running"] == 0


def test_preemption_counters_reach_the_stream(tiny, tmp_path):
    path = tmp_path / "gauges.jsonl"
    eng = _engine(tiny, page_size=4, num_pages=14, max_pages_per_seq=16,
                  max_new_tokens=24, telemetry_path=str(path))
    eng.generate(PROMPTS[:3])
    last = read_stream(path).gauges()[-1]
    assert last["preempted"] > 0
    assert last["evicted_pages"] > 0
    assert last["preempted"] == eng.scheduler.counters["preempted"]
