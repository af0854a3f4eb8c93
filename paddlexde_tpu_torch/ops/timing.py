"""Timing and work bounds for the kernels on the card.

Shared by ``chip_smoke.py`` and ``ops/sweep.py``. Times are CUDA-event
medians (a call as the host sees the card: launches included) or device
times of one kernel from a ``torch.profiler`` trace. A bound is the least
time the card could take for the same work: the larger of the bytes moved
(each input read once, each output written once) over the memory rate and
the operations over their peak rate. A work function gives the bytes and
the operations in two parts, the conv and matrix products and the rest.
Two bounds:

- :func:`bound_ms`, float32 on the CUDA cores: every operation at 67 TFLOP/s;
- :func:`bound_3xtf32_ms`, the products on the tensor cores in 3xTF32 (three
  TF32 products per float32 product, float32 accuracy) at 494.7 / 3
  TFLOP/s, the rest at 67 TFLOP/s, the two times added.

The second is the least time of a float32 kernel that runs its products on
the tensor cores, as the GCN backward K3 and the attention kernels K4 and
K5 do; the first is the least time of one that does not (K1, K2).
"""

from __future__ import annotations

import statistics
from typing import NamedTuple

import torch

__all__ = ["PEAK_BYTES_PER_S", "PEAK_F32_FLOPS", "PEAK_TF32_FLOPS", "Work", "time_ms",
           "device_ms", "device_ms_by_kernel", "bound_ms", "bound_3xtf32_ms", "gcn_work", "gcn_bwd_work", "attn_work",
           "attn_bwd_work"]

# published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, float32
# operations/s on the CUDA cores and TF32 operations/s on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 494.7e12


class Work(NamedTuple):
    """Bytes moved and operations of one call: ``products`` (conv and
    matrix products) and ``other`` (softmax, scaling, sums, elementwise)."""

    bytes: float
    products: float
    other: float

    @property
    def flops(self) -> float:
        return self.products + self.other


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


def device_ms_by_kernel(fn, symbol: str, reps: int = 10) -> dict:
    """Median device time (ms) of each CUDA kernel whose name contains
    ``symbol`` in one call of ``fn``, from a profiler trace of ``reps``
    calls (the wrapper's host-side preparation is not in it)."""
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
    return {name: statistics.median(t) / 1e3 for name, t in by_name.items()}


def device_ms(fn, symbol: str, reps: int = 10) -> float:
    """Median device time (ms) of one call of ``fn`` over the CUDA kernels
    whose names contain ``symbol``: where one call launches several kernels
    (the backward kernels, the attention forward's weight split), the sum of
    each kernel's median (:func:`device_ms_by_kernel`)."""
    return sum(device_ms_by_kernel(fn, symbol, reps).values())


def _bound(t_bytes: float, t_ops: float):
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_ms(work: Work):
    """``(ms, "bytes" | "operations")`` with every operation in float32 on
    the CUDA cores."""
    return _bound(work.bytes / PEAK_BYTES_PER_S * 1e3, work.flops / PEAK_F32_FLOPS * 1e3)


def bound_3xtf32_ms(work: Work):
    """``(ms, "bytes" | "operations")`` with the products in 3xTF32 on the
    tensor cores and the other operations on the CUDA cores."""
    t_ops = work.products / (PEAK_TF32_FLOPS / 3) + work.other / PEAK_F32_FLOPS
    return _bound(work.bytes / PEAK_BYTES_PER_S * 1e3, t_ops * 1e3)


def gcn_work(b: int, n: int, t_len: int, d: int) -> Work:
    """One GCN forward over ``x [b, n, t, d]``: x and gate read, y written;
    per (b, t) slice the scores x x^T and the mix (2 N^2 D products each),
    the softmax and gating (5 N^2)."""
    return Work(4 * (2 * b * n * t_len * d + n * n), b * t_len * 4 * n * n * d,
                b * t_len * 5 * n * n)


def attn_work(b: int, n: int, t_len: int, d: int, heads: int, ks: int) -> Work:
    """One attention forward: three inputs and four conv weights read, the
    output written; per (b, n) row four K-tap convs (the products), the
    scores, softmax and P.V of the attention core."""
    dh = d // heads
    conv = 4 * 2 * ks * d * d * t_len
    core = 4 * heads * t_len * t_len * dh + 3 * heads * t_len * t_len
    return Work(4 * (4 * b * n * t_len * d + 4 * (ks * d * d + d)), b * n * conv, b * n * core)


def gcn_bwd_work(b: int, n: int, t_len: int, d: int) -> Work:
    """One GCN backward: x, g and gate read, dx and dgate written; five N^2 D
    products per (b, t) slice (the scores recomputed, g x^T, a^T g, ds x
    and ds^T x) and the softmax backward."""
    return Work(4 * (3 * b * n * t_len * d + 2 * n * n), b * t_len * 10 * n * n * d,
                b * t_len * 10 * n * n)


def attn_bwd_work(b: int, n: int, t_len: int, d: int, heads: int, ks: int) -> Work:
    """One attention backward: mq, mk, vsrc, g and the four convs' weights
    read; dmq, dmk, dvsrc and the weight gradients written. Per (b, n) row
    eleven conv-sized products (q, k, v recomputed, the out conv's input
    gradient, the three input convs' input gradients, four weight
    gradients) and the attention core (scores and P.V recomputed, dP, dV,
    dQ, dK) with its softmax backward."""
    dh = d // heads
    conv = 11 * 2 * ks * d * d * t_len
    core = 12 * heads * t_len * t_len * dh + 8 * heads * t_len * t_len
    return Work(4 * (7 * b * n * t_len * d + 8 * (ks * d * d + d)), b * n * conv, b * n * core)
