"""PyTorch port vs the JAX reference: ``train/fault.py`` — the straggler
monitor flags the same steps, the heartbeat fires on a stall and not while
beaten, and ``retrying`` retries only transient device errors."""
import threading
import time

import numpy as np
import pytest
import torch

from repro.train import fault as ref_fault
from repro_torch.train import fault


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_monitor_matches_reference(seed):
    rng = np.random.default_rng(seed)
    dts = rng.lognormal(mean=-2.0, sigma=0.8, size=200).tolist()
    dts[50] = dts[120] = 5.0                    # certain stragglers
    mine, ref = fault.StragglerMonitor(), ref_fault.StragglerMonitor()
    flags = [mine.observe(i, dt) for i, dt in enumerate(dts)]
    assert flags == [ref.observe(i, dt) for i, dt in enumerate(dts)]
    assert mine.events == ref.events and mine.ema == ref.ema
    assert flags[50] and flags[120] and not flags[0]


def test_heartbeat_fires_on_a_stall_only():
    fired = threading.Event()
    hb = fault.Heartbeat(0.2, on_stall=fired.set).start()
    try:
        for _ in range(6):                      # beaten: no stall
            time.sleep(0.05)
            hb.beat()
        assert not hb.stalled and not fired.is_set()
        assert fired.wait(5.0)                  # then left alone
        assert hb.stalled
    finally:
        hb.stop()
    hb._thread.join(timeout=5.0)
    assert not hb._thread.is_alive()


def test_retrying_retries_transient_errors_only():
    calls, failures = [], []

    def flaky(x):
        calls.append(x)
        if len(calls) < 3:
            raise torch.AcceleratorError("transient")
        return 2 * x

    step = fault.retrying(flaky, retries=2,
                          on_failure=lambda a, e: failures.append(a))
    assert step(21) == 42
    assert failures == [0, 1] and len(calls) == 3

    calls.clear()
    with pytest.raises(torch.AcceleratorError):
        fault.retrying(flaky, retries=1)(1)     # exhausted: re-raised
    assert len(calls) == 2

    def broken():
        calls.append(None)
        raise RuntimeError("a programming error")

    calls.clear()
    with pytest.raises(RuntimeError, match="programming"):
        fault.retrying(broken, retries=5)()
    assert len(calls) == 1                      # never retried
    assert fault.RETRIABLE == (torch.AcceleratorError,)
    assert not issubclass(torch.cuda.OutOfMemoryError, fault.RETRIABLE)
