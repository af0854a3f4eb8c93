"""The port's prefetch on the cases of tests/test_prefetch.py: order and the
snapshot of a reused buffer, error propagation, depth 0 refused, early close
stopping the producer; and the default transfer's device rule."""

import threading
import time

import numpy as np
import pytest
import torch

from paddlexde_tpu_torch.utils import prefetch


def test_order_snapshot_and_errors(monkeypatch):
    buf = np.zeros(3)

    def gen():
        for i in range(5):
            buf[:] = i  # a reused buffer, like the dataset's
            yield (buf,)

    got = [item[0] for item in prefetch(gen(), depth=2, device="cpu")]
    assert [float(x[0]) for x in got] == [0.0, 1.0, 2.0, 3.0, 4.0]
    assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu" for x in got)

    def failing():
        yield (np.zeros(1),)
        raise RuntimeError("boom")

    it = prefetch(failing(), depth=1, device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="boom"):
        list(it)

    # the default transfer goes to the card, and raises without one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        next(prefetch(iter([(np.zeros(1),)])))


def test_depth_zero_and_early_close():
    with pytest.raises(ValueError):
        next(prefetch(iter([(np.zeros(1),)]), depth=0, device="cpu"))

    n_before = threading.active_count()

    def gen():
        for i in range(1000):
            yield {"x": np.full(3, i)}

    it = prefetch(gen(), depth=2, device="cpu")
    assert float(next(it)["x"][0]) == 0.0
    it.close()  # abandon early
    deadline = time.time() + 5
    while threading.active_count() > n_before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= n_before
