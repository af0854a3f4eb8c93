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
           "gcn_work", "gcn_bwd_work", "attn_work", "attn_bwd_work"]

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
    """Median device time (ms) of one call of ``fn``, from a profiler trace
    of ``reps`` calls, over the CUDA kernels whose names contain ``symbol``
    (the wrapper's host-side preparation is not in it). Where one call
    launches several kernels (the backward kernels), it is the sum of each
    kernel's median."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and symbol in e.name:
            by_name.setdefault(e.name, []).append(e.device_time)
    # a trace can miss launch records (9 of 10 seen at PEMS08 shapes, 3 of
    # 10 for a microsecond kernel); it cannot gain one
    if not by_name or any(not 1 <= len(t) <= reps for t in by_name.values()):
        counts = {k: len(v) for k, v in by_name.items()}
        raise RuntimeError(f"profiler saw launches {counts} of {symbol}, expected {reps} each")
    return sum(statistics.median(t) for t in by_name.values()) / 1e3


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


def gcn_bwd_work(b: int, n: int, t_len: int, d: int):
    """(bytes, float32 operations) of one GCN backward: x, g and gate read,
    dx and dgate written; five N^2 D products per (b, t) slice (the scores
    recomputed, g x^T, a^T g, ds x and ds^T x) and the softmax backward."""
    return (4 * (3 * b * n * t_len * d + 2 * n * n),
            b * t_len * (10 * n * n * d + 10 * n * n))


def attn_bwd_work(b: int, n: int, t_len: int, d: int, heads: int, ks: int):
    """(bytes, float32 operations) of one attention backward: mq, mk, vsrc,
    g and the four convs' weights read; dmq, dmk, dvsrc and the weight
    gradients written. Per (b, n) row eleven conv-sized products (q, k, v
    recomputed, the out conv's input gradient, the three input convs' input
    gradients, four weight gradients) and the attention core (scores and
    P.V recomputed, dP, dV, dQ, dK) with its softmax backward."""
    dh = d // heads
    conv = 2 * ks * d * d * t_len
    per_row = 11 * conv + 12 * heads * t_len * t_len * dh + 8 * heads * t_len * t_len
    return 4 * (7 * b * n * t_len * d + 8 * (ks * d * d + d)), b * n * per_row
