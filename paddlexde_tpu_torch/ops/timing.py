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
  TFLOP/s, the rest at 67 TFLOP/s, the two times added;
- :func:`bound_bf16_ms`, the products on the tensor cores in bfloat16 at
  989 TFLOP/s (dense), those that must stay float32 (``Work.f32_products``,
  the scores of a float32 x in the bfloat16 GCN forward) in 3xTF32, the rest
  at 67 TFLOP/s, the times added.

The second is the least time of a float32 kernel that runs its products on
the tensor cores, as the GCN kernels K2 and K3 and the attention kernels K4
and K5 do; the first is the least time of one that does not (K1); the third
is that of the bfloat16 forms of K2, K4 and K5 and of K3 on a bfloat16
cotangent (whose products stay float32: ``gcn_bwd_work``).
"""

from __future__ import annotations

import statistics
from typing import NamedTuple

import torch

__all__ = ["PEAK_BYTES_PER_S", "PEAK_F32_FLOPS", "PEAK_TF32_FLOPS", "PEAK_BF16_FLOPS", "Work",
           "time_ms", "device_ms", "device_ms_by_kernel", "bound_ms", "bound_3xtf32_ms",
           "bound_bf16_ms", "gcn_work", "gcn_bwd_work", "attn_work", "attn_bwd_work"]

# published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, float32
# operations/s on the CUDA cores and TF32 and bfloat16 operations/s on the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_BF16_FLOPS = 989e12


class Work(NamedTuple):
    """Bytes moved and operations of one call: ``products`` (conv and
    matrix products) and ``other`` (softmax, scaling, sums, elementwise).
    ``f32_products`` is the part of ``products`` that a bfloat16 kernel
    still takes in float32."""

    bytes: float
    products: float
    other: float
    f32_products: float = 0.0

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


# A profiler trace can miss launch records (9 of 10 seen at PEMS08 shapes, 3
# of 10 for a microsecond kernel, once all of them); it cannot gain one. A
# trace that saw none of a kernel's launches is taken again, up to this many
# times in all.
_TRACES = 3


def device_ms_by_kernel(fn, symbol: str, reps: int = 10) -> dict:
    """Median device time (ms) of each CUDA kernel whose name contains
    ``symbol`` in one call of ``fn``, from a profiler trace of ``reps``
    calls (the wrapper's host-side preparation is not in it; see
    ``_TRACES`` for traces that miss launches)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(_TRACES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and symbol in e.name:
                by_name.setdefault(e.name, []).append(e.device_time)
        counts = {k: len(v) for k, v in by_name.items()}
        if any(c > reps for c in counts.values()):
            break
        if by_name:
            return {name: statistics.median(t) / 1e3 for name, t in by_name.items()}
    raise RuntimeError(f"profiler saw launches {counts} of {symbol}, expected {reps} each")


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


def bound_bf16_ms(work: Work):
    """``(ms, "bytes" | "operations")`` with the products in bfloat16 on the
    tensor cores, ``work.f32_products`` of them in 3xTF32, and the other
    operations on the CUDA cores."""
    t_ops = ((work.products - work.f32_products) / PEAK_BF16_FLOPS
             + work.f32_products / (PEAK_TF32_FLOPS / 3) + work.other / PEAK_F32_FLOPS)
    return _bound(work.bytes / PEAK_BYTES_PER_S * 1e3, t_ops * 1e3)


def gcn_work(b: int, n: int, t_len: int, d: int, x_bytes: int = 4, y_bytes: int = 4) -> Work:
    """One GCN forward over ``x [b, n, t, d]``: x (``x_bytes`` per element)
    and the float32 gate read, y (``y_bytes``) written; per (b, t) slice the
    scores x x^T and the mix (2 N^2 D products each), the softmax and gating
    (5 N^2). The scores of a float32 x are float32 products, also in the
    bfloat16 forward (the TPU kernel's float32 scores)."""
    act = b * n * t_len * d
    scores = b * t_len * 2 * n * n * d
    return Work((x_bytes + y_bytes) * act + 4 * n * n, 2 * scores, b * t_len * 5 * n * n,
                scores if x_bytes == 4 else 0.0)


def attn_work(b: int, n: int, t_len: int, d: int, heads: int, ks: int, in_bytes: int = 4,
              out_bytes: int = 4) -> Work:
    """One attention forward: three inputs (``in_bytes`` per element) and
    four float32 conv weights read, the output (``out_bytes``) written; per
    (b, n) row four K-tap convs (the products), the scores, softmax and P.V
    of the attention core."""
    dh = d // heads
    conv = 4 * 2 * ks * d * d * t_len
    core = 4 * heads * t_len * t_len * dh + 3 * heads * t_len * t_len
    act = b * n * t_len * d
    return Work((3 * in_bytes + out_bytes) * act + 4 * 4 * (ks * d * d + d), b * n * conv,
                b * n * core)


def gcn_bwd_work(b: int, n: int, t_len: int, d: int, g_bytes: int = 4) -> Work:
    """One GCN backward: x, g (``g_bytes`` per element) and gate read, dx
    and dgate written; five N^2 D products per (b, t) slice (the scores
    recomputed, g x^T, a^T g, ds x and ds^T x) and the softmax backward.
    Every product is a float32 product, also on a bfloat16 g (the TPU
    kernel computes its bfloat16 form in float32), so the bfloat16 bound
    takes them all in 3xTF32."""
    products = b * t_len * 10 * n * n * d
    return Work(4 * (2 * b * n * t_len * d + 2 * n * n) + g_bytes * b * n * t_len * d, products,
                b * t_len * 10 * n * n, products)


def attn_bwd_work(b: int, n: int, t_len: int, d: int, heads: int, ks: int, in_bytes: int = 4,
                  g_bytes: int = 4) -> Work:
    """One attention backward: mq, mk, vsrc (``in_bytes`` per element), g
    (``g_bytes``) and the four convs' float32 weights read; dmq, dmk, dvsrc
    (in their inputs' dtypes) and the float32 weight gradients written. Per
    (b, n) row eleven conv-sized products (q, k, v recomputed, the out
    conv's input gradient, the three input convs' input gradients, four
    weight gradients) and the attention core (scores and P.V recomputed, dP,
    dV, dQ, dK) with its softmax backward. In bfloat16 the products have
    bfloat16 operands (bfloat16 rate) and the core stays float32 (CUDA
    cores)."""
    dh = d // heads
    conv = 11 * 2 * ks * d * d * t_len
    core = 12 * heads * t_len * t_len * dh + 8 * heads * t_len * t_len
    act = b * n * t_len * d
    return Work((6 * in_bytes + g_bytes) * act + 4 * 8 * (ks * d * d + d), b * n * conv,
                b * n * core)
