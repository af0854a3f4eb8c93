"""Timing and work bounds for the kernels on the card.

Shared by ``chip_smoke.py`` and ``ops/sweep.py``. Times are CUDA-event
medians (a call as the host sees the card: launches included) or device
times of one kernel from a ``torch.profiler`` trace. A bound is the least
time the card could take for the same work: the larger of the bytes moved
(each input read once, each output written once) over the memory rate and
the float32 operations over the CUDA cores' peak rate.
"""

from __future__ import annotations

import statistics

import torch

__all__ = ["PEAK_BYTES_PER_S", "PEAK_F32_FLOPS", "time_ms", "device_ms", "bound_ms",
           "gcn_work", "attn_work"]

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32
# operations/s on the CUDA cores (the kernels run float32 without tensor cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after a warmup."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, symbol: str, reps: int = 10) -> float:
    """Median device time (ms) of one launch of the CUDA kernel whose name
    contains ``symbol``, from a profiler trace of ``reps`` calls of ``fn``
    (the wrapper's host-side preparation is not in it)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.device_time for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and symbol in e.name]
    # a trace can miss launch records (9 of 10 seen at PEMS08 shapes, 3 of
    # 10 for a microsecond kernel); it cannot gain one
    if not 1 <= len(times) <= reps:
        raise RuntimeError(f"profiler saw {len(times)} launches of {symbol}, expected {reps}")
    return statistics.median(times) / 1e3


def bound_ms(n_bytes: float, n_flops: float):
    """``(ms, "bytes" | "operations")``: the larger of the two times."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gcn_work(b: int, n: int, t_len: int, d: int):
    """(bytes, float32 operations) of one GCN forward over ``x [b, n, t, d]``:
    x and gate read, y written; scores, softmax and the mix."""
    return 4 * (2 * b * n * t_len * d + n * n), b * t_len * (4 * n * n * d + 5 * n * n)


def attn_work(b: int, n: int, t_len: int, d: int, heads: int, ks: int):
    """(bytes, float32 operations) of one attention forward: three inputs
    and four conv weights read, the output written; four K-tap convs, the
    scores, softmax and P.V per (b, n) row."""
    dh = d // heads
    per_row = 4 * 2 * ks * d * d * t_len + 4 * heads * t_len * t_len * dh + 3 * heads * t_len * t_len
    return 4 * (4 * b * n * t_len * d + 4 * (ks * d * d + d)), b * n * per_row
