"""The port's cli.common.HostWorkPool (the --host_workers thread pool),
held to the behaviours tests/test_host_pool.py pins for the JAX package's."""
import threading
import time

import pytest

from image_denoising_tpu_torch.cli.common import HostWorkPool


def test_inline_mode_runs_immediately():
    seen = []
    pool = HostWorkPool(0, seen.append)
    for i in range(5):
        pool.submit(lambda k: k * 10, i)
        assert seen[-1] == i * 10  # finalized synchronously inside submit
    pool.close()
    assert seen == [0, 10, 20, 30, 40]


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_finalize_order_is_submission_order(workers):
    """Tasks finishing out of order must still finalize in frame order —
    stdout lines and MetricsWriter contents depend on it."""
    out = []
    pool = HostWorkPool(workers, out.append)

    def task(i):
        time.sleep(0.002 * ((7 * i) % 5))  # jittered completion order
        return i

    for i in range(20):
        pool.submit(task, i)
    pool.close()
    assert out == list(range(20))


def test_workers_actually_parallelize():
    """With 2 workers, 2 GIL-releasing tasks overlap (wall < serial sum).
    sleep needs no CPU, so this holds even on a loaded 1-core host; the
    0.25 s margin absorbs thread start-up jitter."""
    pool = HostWorkPool(2, lambda r: None)
    t0 = time.perf_counter()
    for _ in range(2):
        pool.submit(time.sleep, 0.3)
    pool.close()
    assert time.perf_counter() - t0 < 0.55  # serial would be >= 0.6


def test_pending_window_is_bounded():
    """submit() must block once 2*workers+2 tasks are pending, so peak RAM
    holds a few frames, not the whole run."""
    gate = threading.Event()
    started = []
    pool = HostWorkPool(1, lambda r: None)

    def task(i):
        started.append(i)
        gate.wait(2.0)
        return i

    t = threading.Thread(
        target=lambda: [pool.submit(task, i) for i in range(10)])
    t.start()
    time.sleep(0.3)
    # bound = 2*1+2 = 4 pending + the submitter blocked on the 5th
    assert len(pool._pending) <= 5
    gate.set()
    t.join(5.0)
    pool.close()
    assert started == list(range(10))


def test_exceptions_propagate():
    pool = HostWorkPool(1, lambda r: None)

    def boom():
        raise ValueError("task failed")

    # the failure surfaces at the next order-preserving drain point —
    # either a later submit() or close()
    with pytest.raises(ValueError, match="task failed"):
        pool.submit(boom)
        time.sleep(0.05)
        pool.submit(lambda: None)
        pool.close()


def test_context_manager_aborts_on_error():
    """Leaving the `with` block on an exception must NOT finalize queued
    frames (a failing CLI shouldn't keep writing PNGs behind the traceback)
    and must shut the executor down so nothing leaks to atexit."""
    finalized = []
    ran = []

    def task(i):
        time.sleep(0.05)
        ran.append(i)
        return i

    with pytest.raises(RuntimeError, match="device loop failed"):
        with HostWorkPool(1, finalized.append) as pool:
            for i in range(6):
                pool.submit(task, i)
            raise RuntimeError("device loop failed")
    assert pool._pool is None  # executor shut down
    n_after_abort = len(ran)
    time.sleep(0.2)
    assert len(ran) == n_after_abort  # cancelled tasks never ran
    assert finalized == sorted(finalized)  # any pre-error finalizes ordered
    assert len(finalized) < 6


def test_context_manager_closes_on_success():
    out = []
    with HostWorkPool(2, out.append) as pool:
        for i in range(5):
            pool.submit(lambda k: k, i)
    assert out == list(range(5))
    assert pool._pool is None
