#!/usr/bin/env python3
"""Drive the PyTorch port of D3STN serving and training on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds the five hand-written Hopper kernels from ``paddlexde_tpu_torch/
ops/csrc``, prints the compiler's registers, spills and shared memory of
the GCN backward and attention kernels and the count of tensor-core
instructions in their libraries (it fails if one has none, or if a GCN
backward kernel spills), and runs three phases (PyTorch's TF32 off
throughout; the GCN backward and attention kernels run their products in
3xTF32):

1. each kernel against its plain PyTorch version at the PEMS08 shapes: the
   forward kernels against the float32 and float64 plain versions, the
   backward kernels (GCN K3, attention K5) against the float32 and float64
   plain backward (K3 within 1e-5 of float64), each run twice and required
   to give the same bits, with K3's and K5's device time per kernel;
2. serving: PEMS08-width ``Predictor`` requests (random weights from a
   seeded generator) through the kernels and against the same Predictor
   forced to the plain versions;
3. training: the PEMS08 config at batch 32 on a synthetic series; one
   ``Trainer`` step on the kernels against one on the plain versions (loss
   and every gradient), the launches of a step by counter and profiler, the
   step time, then a short two-phase ``Trainer.train()`` whose best
   checkpoint a ``Predictor`` serves through the kernels.

Launch counts are checked by the wrappers' counters and by ``torch.profiler``
traces. It prints:

- the card's name and power limit (``nvidia-smi``);
- one JSON line ``{"kernels": [...]}`` with each kernel's launches on the
  main paths (serving and the two-epoch train), error, time, bound (the
  3xTF32 bound of ``ops/timing.py``), plain-version time and library time;
- as the last line, ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the result lines. With no CUDA card, or
without the ``paddlexde_tpu_torch`` package beside this file, it fails too.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

TOL = {"spline": 1e-5, "gcn_fwd": 1e-4, "gcn_bwd": 1e-4, "attn_fwd": 1e-4, "attn_bwd": 1e-4}
# the GCN backward (3xTF32 on the tensor cores) against the float64 plain
# backward
GCN_BWD_TOL64 = 1e-5
PREDICTOR_TOL = 5e-4
# the train step on the kernels against the plain versions on the card:
# loss relative, each gradient tensor normalised max-abs
TRAIN_TOL = 1e-3
LAUNCHES_PER_BATCH = {"spline": 2, "gcn_fwd": 4, "gcn_bwd": 0, "attn_fwd": 6, "attn_bwd": 0}
LAUNCHES_PER_STEP = {"spline": 4, "gcn_fwd": 4, "gcn_bwd": 4, "attn_fwd": 6, "attn_bwd": 6}
# CUDA symbol substrings in a profiler trace; one wrapper call launches one
# kernel of each symbol
KERNEL_NAMES = {
    "spline": ("hermite_gather_kernel",),
    "gcn_fwd": ("gcn_fwd_",),  # gcn_fwd_d128_tiled_kernel (D=128) or gcn_fwd_kernel
    "gcn_bwd": ("gcn_bwd_row_tc_kernel", "gcn_bwd_col_tc_kernel", "gcn_bwd_dgate_kernel"),
    "attn_fwd": ("attn_fwd_wsplit_kernel", "attn_fwd_d3stn_kernel"),  # D3STN's shape
    "attn_bwd": ("attn_bwd_wt_kernel", "attn_bwd_qkv_conv_kernel", "attn_bwd_core_kernel",
                 "attn_bwd_dx_conv_kernel", "attn_bwd_dw_kernel", "attn_bwd_sum_kernel"),
}
SOURCES = {
    "spline": ("paddlexde_tpu_torch/ops/csrc/spline.cu", "paddlexde_tpu/ops/spline_pallas.py:84"),
    "gcn_fwd": ("paddlexde_tpu_torch/ops/csrc/gcn.cu", "paddlexde_tpu/ops/gcn_pallas.py:54"),
    "gcn_bwd": ("paddlexde_tpu_torch/ops/csrc/gcn_bwd.cu", "paddlexde_tpu/ops/gcn_pallas.py:70"),
    "attn_fwd": ("paddlexde_tpu_torch/ops/csrc/attn.cu", "paddlexde_tpu/ops/attn_pallas.py:248"),
    "attn_bwd": ("paddlexde_tpu_torch/ops/csrc/attn_bwd.cu", "paddlexde_tpu/ops/attn_pallas.py:494"),
}



class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def norm_err(got, want):
    """max |got - want| / max |want| (plain float)."""
    scale = want.abs().max().item()
    return (got - want).abs().max().item() / (scale if scale > 0 else 1.0)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    require(out, "nvidia-smi printed no card")
    return out[0]


def ptxas_report(log):
    """``[(kernel, registers, spill stores, spill loads, stack bytes)]`` from
    the ``-Xptxas -v`` lines of an nvcc log (kernel names mangled)."""
    import re

    rows, name, spill = [], None, (0, 0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = tuple(int(x) for x in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), spill[1], spill[2], spill[0]))
            name, spill = None, (0, 0, 0)
    return rows


def build_report():
    """Registers and spills of every kernel of the three tensor-core
    libraries (GCN backward, attention forward and backward), and the
    tensor-core instructions (HMMA/HGMMA) in their SASS. The GCN backward's
    kernels must not spill."""
    from paddlexde_tpu_torch.ops import _build

    for lib in ("gcn_bwd", "attn", "attn_bwd"):
        log = _build.build_log(lib)
        for line in log.splitlines():
            if "warning" in line.lower():
                print(f"  nvcc {lib}: {line.strip()}", flush=True)
        for name, regs, stores, loads, stack in ptxas_report(log):
            print(f"  ptxas {lib}: {name}: {regs} registers, spill stores {stores} B, "
                  f"spill loads {loads} B, stack {stack} B", flush=True)
            require(lib != "gcn_bwd" or stores + loads == 0, f"{lib}: {name} spills")
        sass = subprocess.run([_build.tool("cuobjdump"), "-sass", str(_build.library_path(lib))],
                              capture_output=True, text=True, timeout=600, check=True).stdout
        n_tc = sum(1 for line in sass.splitlines() if "HMMA" in line or "HGMMA" in line)
        print(f"  {lib}: {n_tc} tensor-core instructions (HMMA/HGMMA) in the SASS", flush=True)
        require(n_tc > 0, f"the {lib} library has no tensor-core instruction")


# --------------------------------------------------------------------------
# phase 1: every kernel against its plain version at the PEMS08 shapes
# --------------------------------------------------------------------------


def check_spline(torch, dev, gen):
    from paddlexde_tpu_torch.ops import spline
    from paddlexde_tpu_torch.ops.timing import Work, bound_3xtf32_ms, bound_ms, device_ms, time_ms

    b, n, t_len, d = 32, 170, 2016, 3
    series = torch.randn(b, n, t_len, d, generator=gen, device=dev)
    t = torch.arange(t_len, dtype=torch.float32, device=dev)
    # on knots, fractional, in the last interval, at the last knot, out of range
    q = torch.tensor([0.0, 1.0, 7.25, 1000.0, 1500.5, 2013.75, 2014.0, 2014.3,
                      2014.9, 2015.0, -3.5, 2100.0], device=dev)
    errs = []
    for derivative in (False, True):
        got = spline.gather_eval_kernel(series, t, q, derivative)
        want = spline.gather_eval_plain(series, t, q, derivative)
        torch.cuda.synchronize()
        require(torch.isfinite(got).all().item(), "spline kernel: non-finite output")
        errs.append(norm_err(got, want))
    ms = device_ms(lambda: spline.gather_eval_kernel(series, t, q), KERNEL_NAMES["spline"][0])
    wrapper_ms = time_ms(lambda: spline.gather_eval_kernel(series, t, q))
    plain_ms = time_ms(lambda: spline.gather_eval_plain(series, t, q))
    # the lag backward: the same kernel with the derivative basis
    deriv_ms = device_ms(lambda: spline.gather_eval_kernel(series, t, q, True),
                         KERNEL_NAMES["spline"][0])
    deriv_plain_ms = time_ms(lambda: spline.gather_eval_plain(series, t, q, True))
    idx, _, _ = spline._prep(series, t, q)
    rows_read = set()
    for i in idx.tolist():
        rows_read.update({i, i + 1, min(i + 2, t_len - 1)})
    n_bytes = 4 * (b * n * d * len(rows_read) + b * n * q.numel() * d + t_len + q.numel())
    n_flops = 11 * b * n * q.numel() * d
    work = Work(n_bytes, 0, n_flops)
    bound = bound_ms(work)
    print(f"  spline derivative basis (the lag backward): kernel {deriv_ms:.4f} ms (device, "
          f"profiler), plain {deriv_plain_ms:.4f} ms (CUDA events), bound {bound[0]:.6f} ms by "
          f"{bound[1]}, launches per train step 2", flush=True)
    return dict(err=max(errs), ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                bound=bound, bound3=bound_3xtf32_ms(work), deriv_ms=deriv_ms, deriv_plain_ms=deriv_plain_ms,
                shape=f"series [{b},{n},{t_len},{d}], L={q.numel()}")


def check_gcn(torch, dev, gen):
    from paddlexde_tpu_torch.ops import gcn
    from paddlexde_tpu_torch.ops.timing import bound_3xtf32_ms, bound_ms, device_ms, gcn_work, time_ms

    b, n, t_len, d = 32, 170, 12, 128
    x = torch.randn(b, n, t_len, d, generator=gen, device=dev)
    gate = 0.5 * torch.rand(n, n, generator=gen, device=dev)
    scale2 = 1.0 / d ** 0.5
    got = gcn.gcn_spatial_mix_kernel(x, gate, scale2)
    want = gcn.gcn_spatial_mix_plain(x, gate, scale2)
    torch.cuda.synchronize()
    require(torch.isfinite(got).all().item(), "gcn kernel: non-finite output")
    err = norm_err(got, want)
    # the float32 kernel and plain version may sum in the same order; the
    # float64 plain version shows the kernel is right on its own
    err64 = norm_err(got.double(), gcn.gcn_spatial_mix_plain(x.double(), gate.double(), scale2,
                                                             dtype_name="float64"))
    require(err64 <= TOL["gcn_fwd"], f"gcn kernel vs float64 plain: {err64:.3e}")
    ms = device_ms(lambda: gcn.gcn_spatial_mix_kernel(x, gate, scale2), KERNEL_NAMES["gcn_fwd"][0])
    wrapper_ms = time_ms(lambda: gcn.gcn_spatial_mix_kernel(x, gate, scale2))
    plain_ms = time_ms(lambda: gcn.gcn_spatial_mix_plain(x, gate, scale2))
    return dict(err=err, err64=err64, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                bound=bound_ms(gcn_work(b, n, t_len, d)),
                bound3=bound_3xtf32_ms(gcn_work(b, n, t_len, d)),
                shape=f"x [{b},{n},{t_len},{d}], gate [{n},{n}]")


def check_attn(torch, dev, gen):
    from paddlexde_tpu_torch.ops import attn
    from paddlexde_tpu_torch.ops.timing import (
        attn_work,
        bound_3xtf32_ms,
        bound_ms,
        device_ms,
        device_ms_by_kernel,
        time_ms,
    )

    b, n, t_len, d, heads, ks = 32, 170, 12, 128, 8, 3
    mq, mk, vs = (torch.randn(b, n, t_len, d, generator=gen, device=dev) for _ in range(3))
    bound = (6.0 / (2 * ks * d)) ** 0.5
    weights = []
    for _ in range(4):
        weights.append((2 * torch.rand(ks, d, d, generator=gen, device=dev) - 1) * bound)
        weights.append(0.1 * torch.randn(d, generator=gen, device=dev))
    errs, errs64, times, wrapper_times, plain_times = [], [], [], [], []
    for flags in ((False, False, False), (True, True, True), (True, False, False)):
        args = (mq, mk, vs, *weights, *flags, heads)
        got = attn.fused_temporal_attention_kernel(*args)
        want = attn.fused_temporal_attention_plain(*args)
        torch.cuda.synchronize()
        require(torch.isfinite(got).all().item(), f"attention kernel {flags}: non-finite output")
        errs.append(norm_err(got, want))
        want64 = attn.fused_temporal_attention_plain(
            *[a.double() for a in args[:11]], *flags, heads, dtype_name="float64")
        errs64.append(norm_err(got.double(), want64))
        require(errs64[-1] <= TOL["attn_fwd"], f"attention kernel vs float64 plain: {errs64[-1]:.3e}")
        times.append(device_ms(lambda: attn.fused_temporal_attention_kernel(*args), "attn_fwd_"))
        print_by_kernel(device_ms_by_kernel(lambda: attn.fused_temporal_attention_kernel(*args),
                                            "attn_fwd_"), flags)
        wrapper_times.append(time_ms(lambda: attn.fused_temporal_attention_kernel(*args)))
        plain_times.append(time_ms(lambda: attn.fused_temporal_attention_plain(*args)))
    return dict(err=max(errs), err64=max(errs64), ms=statistics.mean(times),
                wrapper_ms=statistics.mean(wrapper_times),
                plain_ms=statistics.mean(plain_times),
                bound=bound_ms(attn_work(b, n, t_len, d, heads, ks)),
                bound3=bound_3xtf32_ms(attn_work(b, n, t_len, d, heads, ks)),
                per_flags=list(zip(errs, times, plain_times)),
                shape=f"[{b},{n},{t_len},{d}], H={heads}, K={ks}, 3 flag sets")


def print_by_kernel(by_name, flags=None):
    """One line of device ms per kernel of a wrapper call."""
    import re

    parts = []
    for name, ms in by_name.items():
        m = re.search(r"(attn|gcn)_\w+?_kernel(<[^>]*>)?", name)
        parts.append(f"{m.group(0) if m else name[:60]} {ms:.4f}")
    label = "" if flags is None else f"flags {flags}, "
    print(f"  {label}device ms by kernel: " + ", ".join(parts), flush=True)


def same_bits(torch, first, second):
    return all(torch.equal(a, b) for a, b in zip(first, second))


def check_gcn_bwd(torch, dev, gen):
    from paddlexde_tpu_torch.ops import gcn
    from paddlexde_tpu_torch.ops.timing import (
        bound_3xtf32_ms,
        bound_ms,
        device_ms_by_kernel,
        gcn_bwd_work,
        time_ms,
    )

    b, n, t_len, d = 32, 170, 12, 128
    x = torch.randn(b, n, t_len, d, generator=gen, device=dev)
    gate = 0.5 * torch.rand(n, n, generator=gen, device=dev)
    g = torch.randn(b, n, t_len, d, generator=gen, device=dev)
    scale2 = 1.0 / d ** 0.5
    run = lambda: gcn.gcn_spatial_mix_bwd_kernel(x, gate, g, scale2)  # noqa: E731
    got, again = run(), run()
    torch.cuda.synchronize()
    require(all(torch.isfinite(a).all().item() for a in got), "gcn_bwd kernel: non-finite output")
    require(same_bits(torch, got, again), "gcn_bwd kernel: two runs on the same inputs differ")
    want = gcn.gcn_spatial_mix_bwd_plain(x, gate, g, scale2)
    want64 = gcn.gcn_spatial_mix_bwd_plain(x.double(), gate.double(), g.double(), scale2)
    err = max(norm_err(a, w) for a, w in zip(got, want))
    err64 = max(norm_err(a.double(), w) for a, w in zip(got, want64))
    require(err64 <= GCN_BWD_TOL64, f"gcn_bwd kernel vs float64 plain: {err64:.3e} "
            f"(tol {GCN_BWD_TOL64:g})")
    del want, want64
    by_kernel = device_ms_by_kernel(run, "gcn_bwd_")
    print_by_kernel(by_kernel)
    return dict(err=err, err64=err64, ms=sum(by_kernel.values()), wrapper_ms=time_ms(run),
                plain_ms=time_ms(lambda: gcn.gcn_spatial_mix_bwd_plain(x, gate, g, scale2)),
                bound=bound_ms(gcn_bwd_work(b, n, t_len, d)),
                bound3=bound_3xtf32_ms(gcn_bwd_work(b, n, t_len, d)),
                shape=f"x, g [{b},{n},{t_len},{d}] -> dx, dgate [{n},{n}]; bitwise equal twice")


def check_attn_bwd(torch, dev, gen):
    from paddlexde_tpu_torch.ops import attn
    from paddlexde_tpu_torch.ops.timing import (
        attn_bwd_work,
        bound_3xtf32_ms,
        bound_ms,
        device_ms,
        device_ms_by_kernel,
        time_ms,
    )

    b, n, t_len, d, heads, ks = 32, 170, 12, 128, 8, 3
    mq, mk, vs, g = (torch.randn(b, n, t_len, d, generator=gen, device=dev) for _ in range(4))
    bound = (6.0 / (2 * ks * d)) ** 0.5
    weights = []
    for _ in range(4):
        weights.append((2 * torch.rand(ks, d, d, generator=gen, device=dev) - 1) * bound)
        weights.append(0.1 * torch.randn(d, generator=gen, device=dev))
    errs, errs64, times, wrapper_times, plain_times = [], [], [], [], []
    for flags in ((False, False, False), (True, True, True), (True, False, False)):
        args = (mq, mk, vs, *weights, g, *flags, heads)
        run = lambda: attn.fused_temporal_attention_bwd_kernel(*args)  # noqa: E731
        got, again = run(), run()
        torch.cuda.synchronize()
        require(all(torch.isfinite(a).all().item() for a in got),
                f"attn_bwd kernel {flags}: non-finite output")
        require(same_bits(torch, got, again), f"attn_bwd kernel {flags}: two runs differ")
        errs.append(max(attn.bwd_errors(got, attn.fused_temporal_attention_bwd_plain(*args))))
        want64 = attn.fused_temporal_attention_bwd_plain(
            *[a.double() for a in args[:12]], *flags, heads)
        errs64.append(max(attn.bwd_errors(got, want64)))
        del want64
        require(errs64[-1] <= TOL["attn_bwd"], f"attn_bwd kernel vs float64 plain: {errs64[-1]:.3e}")
        times.append(device_ms(run, "attn_bwd_"))
        print_by_kernel(device_ms_by_kernel(run, "attn_bwd_"), flags)
        wrapper_times.append(time_ms(run))
        plain_times.append(time_ms(lambda: attn.fused_temporal_attention_bwd_plain(*args)))
    return dict(err=max(errs), err64=max(errs64), ms=statistics.mean(times),
                wrapper_ms=statistics.mean(wrapper_times),
                plain_ms=statistics.mean(plain_times),
                bound=bound_ms(attn_bwd_work(b, n, t_len, d, heads, ks)),
                bound3=bound_3xtf32_ms(attn_bwd_work(b, n, t_len, d, heads, ks)),
                per_flags=list(zip(errs, times, plain_times)),
                shape=f"[{b},{n},{t_len},{d}], H={heads}, K={ks}, 3 flag sets, 11 gradients; "
                      "bitwise equal twice")


def kernel_phase(torch, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for name, fn in (("spline", check_spline), ("gcn_fwd", check_gcn), ("gcn_bwd", check_gcn_bwd),
                     ("attn_fwd", check_attn), ("attn_bwd", check_attn_bwd)):
        res = fn(torch, dev, gen)
        print(f"kernel {name} ({res['shape']}): max_abs_err(normalised)={res['err']:.3e} "
              f"(tol {TOL[name]:g}) kernel {res['ms']:.4f} ms (device, profiler), wrapper "
              f"{res['wrapper_ms']:.4f} ms, plain {res['plain_ms']:.4f} ms (CUDA events), "
              f"bound {res['bound'][0]:.4f} ms by {res['bound'][1]} (float32, CUDA cores), "
              f"{res['bound3'][0]:.4f} ms by {res['bound3'][1]} (3xTF32 products), "
              f"launches per Predictor batch {LAUNCHES_PER_BATCH[name]}, "
              f"per train step {LAUNCHES_PER_STEP[name]}", flush=True)
        if "err64" in res:
            print(f"  vs the plain version in float64: {res['err64']:.3e}", flush=True)
        for flags_res in res.get("per_flags", ()):
            print(f"  flag set: err {flags_res[0]:.3e}, kernel {flags_res[1]:.4f} ms (device), "
                  f"plain {flags_res[2]:.4f} ms", flush=True)
        require(res["err"] <= TOL[name], f"{name}: kernel disagrees with its plain version "
                f"({res['err']:.3e} > {TOL[name]:g})")
        results[name] = res
    return results


# --------------------------------------------------------------------------
# phase 2: the main path -- PEMS08-width Predictor requests through the kernels
# --------------------------------------------------------------------------


def make_series(np, n, t_len, seed):
    """A traffic-like scaled series [N, T, 3]: value, day-of-week, time-of-day."""
    rng = np.random.default_rng(seed)
    steps = np.arange(t_len)
    phase = rng.uniform(0, 2 * np.pi, (n, 1))
    value = 0.5 * np.sin(2 * np.pi * steps / 288 + phase) + 0.1 * rng.standard_normal((n, t_len))
    dow = np.broadcast_to((steps // 288) % 7, (n, t_len))
    tod = np.broadcast_to(steps % 288, (n, t_len))
    return np.stack([value, dow, tod], axis=-1).astype(np.float32)


def serve(pred, series, windows, starts):
    """The requests of one run: 2 batches of 32, a ragged batch of 7, one
    predict_series over the resident series. Returns the outputs and the
    host-clock seconds of each request."""
    outs, secs = [], []
    for batch in (windows[:32], windows[32:64], windows[57:64]):
        t0 = time.perf_counter()
        outs.append(pred(batch))
        secs.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    outs.append(pred.predict_series(series, starts))
    secs.append(time.perf_counter() - t0)
    return outs, secs


def predictor_phase(torch, dev):
    import dataclasses

    import numpy as np

    from paddlexde_tpu_torch import history_index
    from paddlexde_tpu_torch.models.d3stn import Predictor, load_config
    from paddlexde_tpu_torch.ops import _build
    from paddlexde_tpu_torch.ops.timing import time_ms

    class PlainPredictor(Predictor):
        """The reference: the spline class in place of the spline kernel."""

        def _history(self, lags, src):
            return history_index(lags, src, self.his_span, interpolation="cubic",
                                 use_kernel=False)

    cfg = load_config(str(HERE / "examples" / "configs" / "PEMS08.json"))
    plain_cfg = dataclasses.replace(cfg, attn_impl="xla", gcn_impl="xla")
    n, his = cfg.num_nodes, cfg.his_len
    rng = np.random.default_rng(0)
    a = rng.random((n, n))
    sc = ((a + a.T) / 2).astype(np.float32)
    adj = (rng.random((n, n)) < 0.03).astype(np.float32)
    adj = np.maximum(adj, adj.T)
    enc = (np.arange(his - 2016, his - 2016 + 12) + rng.random(12)).astype(np.float32)
    dec = (his - 1 - 1.5 * rng.random(cfg.tgt_len)).astype(np.float32)

    pred = Predictor(cfg, None, enc, dec, adj, sc, batch_size=32, device=dev,
                     generator=torch.Generator().manual_seed(0))
    plain = PlainPredictor(plain_cfg, None, enc, dec, adj, sc, batch_size=32, device=dev,
                      generator=torch.Generator().manual_seed(0))
    plain.model.load_state_dict(pred.model.state_dict())
    n_params = sum(p.numel() for p in pred.model.parameters())
    print(f"Predictor: PEMS08 config (N={n}, his_len={his}, d_model={cfg.d_model}, "
          f"heads={cfg.head}, {cfg.encoder_num_layers}+{cfg.decoder_num_layers} layers, "
          f"top_k={cfg.top_k}), {n_params} random parameters (seed 0)", flush=True)

    series = make_series(np, n, his + 64, seed=1)
    starts = np.arange(65)
    windows = np.stack([series[:, s : s + his] for s in range(64)])
    pred.warmup()
    plain.warmup()

    _build.reset_launches()
    outs, secs = serve(pred, series, windows, starts)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    n_batches = 3 + -(-len(starts) // pred.batch_size)
    plain_outs, plain_secs = serve(plain, series, windows, starts)
    print(f"main path: {n_batches} Predictor batches, launches {launches}", flush=True)
    for name, per_batch in LAUNCHES_PER_BATCH.items():
        require(launches[name] == per_batch * n_batches,
                f"{name}: {launches[name]} launches on the main path, expected "
                f"{per_batch} x {n_batches} batches")

    shapes = [(32, n, cfg.tgt_len), (32, n, cfg.tgt_len), (7, n, cfg.tgt_len),
              (len(starts), n, cfg.tgt_len)]
    for out, ref, shape in zip(outs, plain_outs, shapes):
        require(out.shape == shape, f"Predictor output {out.shape}, expected {shape}")
        require(np.isfinite(out).all(), "Predictor output is not finite")
        err = np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)
        print(f"  request {shape}: kernels vs plain versions on the card, "
              f"normalised max-abs err {err:.3e} (tol {PREDICTOR_TOL:g})", flush=True)
        require(err <= PREDICTOR_TOL, f"Predictor {shape} disagrees with the plain path: {err:.3e}")
    require(np.array_equal(outs[3][:64], np.concatenate([outs[0], outs[1]])),
            "predict_series differs from the host-window path")
    ragged_err = np.abs(outs[2] - outs[1][25:32]).max() / np.abs(outs[1]).max()
    require(ragged_err <= 1e-6, f"the ragged batch differs from the full batch ({ragged_err:.3e})")
    for label, s in (("kernels", secs), ("plain", plain_secs)):
        print(f"  {label}: request seconds (host clock, host array in, numpy out): "
              f"batch32 {s[0]:.4f}, batch32 {s[1]:.4f}, batch7 {s[2]:.4f}, "
              f"predict_series({len(starts)}) {s[3]:.4f} -> "
              f"{32 / s[1]:.1f} samples/s at batch 32, "
              f"{len(starts) / s[3]:.1f} samples/s resident", flush=True)

    # steady-state device latency of one resident batch of 32
    src = torch.as_tensor(windows[:32]).to(dev)
    fwd_ms = time_ms(lambda: pred.forward(src), reps=10)
    plain_fwd_ms = time_ms(lambda: plain.forward(src), reps=10)
    print(f"  Predictor.forward, resident batch of 32 (CUDA events, median of 10): "
          f"kernels {fwd_ms:.3f} ms ({32e3 / fwd_ms:.1f} samples/s), "
          f"plain {plain_fwd_ms:.3f} ms ({32e3 / plain_fwd_ms:.1f} samples/s)", flush=True)

    traced_launches(torch, lambda: pred.forward(src), LAUNCHES_PER_BATCH, "one batch of 32")
    return launches


def trace(torch, fn):
    """Launches per kernel key and symbol, total device time (us) and device
    time per kernel name, from a profiler trace of one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {k: [0] * len(symbols) for k, symbols in KERNEL_NAMES.items()}
    device_us, by_name = 0.0, {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        device_us += evt.device_time
        by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.device_time
        for key, symbols in KERNEL_NAMES.items():
            for i, symbol in enumerate(symbols):
                if symbol in evt.name:
                    counts[key][i] += 1
    return counts, device_us, by_name


def traced_launches(torch, fn, expected, label):
    """Every kernel symbol launched exactly ``expected[key]`` times in a
    profiler trace of ``fn``. A trace can drop a launch record (seen once in a
    10-launch trace), never add one: up to 3 traces, the first with every
    count exact passes. Returns the device time (us) and the time by kernel
    name of that trace."""
    for attempt in range(3):
        counts, device_us, by_name = trace(torch, fn)
        print(f"  profiler, {label} (trace {attempt + 1}): kernel launches {counts}, "
              f"device time {device_us / 1e3:.3f} ms in {len(by_name)} kernel names", flush=True)
        for key, per_call in expected.items():
            require(max(counts[key]) <= per_call,
                    f"profiler shows {counts[key]} {key} launches in {label}, expected {per_call}")
        exact = all(c == per_call for key, per_call in expected.items() for c in counts[key])
        if exact:
            break
    require(exact, f"profiler shows launches {counts} in {label}, expected {expected} of each")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {us / 1e3:9.4f} ms  {name[:100]}", flush=True)
    return device_us, by_name


# --------------------------------------------------------------------------
# phase 3: the train path -- PEMS08-width Trainer steps through the kernels
# --------------------------------------------------------------------------


def grad_errors(names, got, want):
    """Normalised max-abs error of each gradient tensor; the key-conv bias
    gradients (zero in exact arithmetic) against the scale of their module's
    other conv-bias gradients."""
    want_by = dict(zip(names, want))
    errs = {}
    for name, a, w in zip(names, got, want):
        scale = w.abs().max().item()
        if name.endswith("key_conv.bias"):
            prefix = name[: -len("key_conv.bias")]
            scale = max(want_by[prefix + c + "_conv.bias"].abs().max().item()
                        for c in ("query", "value", "out"))
        errs[name] = (a - w).abs().max().item() / scale if scale > 0 else (a - w).abs().max().item()
    return errs


def train_phase(torch, dev):
    import dataclasses
    import shutil

    import numpy as np

    from paddlexde_tpu_torch import history_index
    from paddlexde_tpu_torch.models.d3stn import (
        Predictor,
        Trainer,
        load_config,
        synthetic_traffic_npz,
    )
    from paddlexde_tpu_torch.ops import _build
    from paddlexde_tpu_torch.ops.timing import time_ms

    class PlainTrainer(Trainer):
        """The reference: the spline class in place of the spline kernel."""

        def _history(self, lags, src):
            return history_index(lags, src, self.his_span, interpolation="cubic",
                                 use_kernel=False)

    save_dir = HERE / "experiments" / "chip_smoke"
    shutil.rmtree(save_dir, ignore_errors=True)
    cfg = load_config(str(HERE / "examples" / "configs" / "PEMS08.json"), batch_size=32,
                      train_epochs=1, finetune_epochs=1, save_dir=str(save_dir))
    plain_cfg = dataclasses.replace(cfg, attn_impl="xla", gcn_impl="xla",
                                    save_dir=str(save_dir / "plain"))
    n = cfg.num_nodes
    rng = np.random.default_rng(0)
    a = rng.random((n, n))
    sc = ((a + a.T) / 2).astype(np.float32)
    adj = (rng.random((n, n)) < 0.03).astype(np.float32)
    adj = np.maximum(adj, adj.T)
    data = synthetic_traffic_npz(num_nodes=n, seq_len=288 * 14)
    t0 = time.perf_counter()
    tr = Trainer(cfg, data=data, adj_matrix=adj, sc_matrix=sc, device=dev)
    plain = PlainTrainer(plain_cfg, data=data, adj_matrix=adj, sc_matrix=sc, device=dev)
    plain.model.load_state_dict(tr.model.state_dict())
    n_params = sum(p.numel() for p in tr.model.parameters())
    print(f"Trainer: PEMS08 config at batch 32 ({cfg.encoder_num_layers}+"
          f"{cfg.decoder_num_layers} layers, d_model {cfg.d_model}, his_len {cfg.his_len}), "
          f"{n_params} random parameters (seed {cfg.seed}), synthetic series [N={n}, "
          f"T={data.shape[0]}], {len(tr.train_dataset)} train / {len(tr.val_dataset)} val / "
          f"{len(tr.test_dataset)} test windows; built in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 1. one step's loss and gradients: kernels against the plain versions
    starts = next(tr.train_dataset.batch_starts(cfg.batch_size, shuffle=True, seed=cfg.seed))
    src, tgt = tr.windows(starts)
    kl = 1.0  # the alignment term on, though the schedule enables it only at warmup_step
    outs = []
    for trainer in (tr, plain):
        total, loss, align = trainer.loss_fn(src, tgt, kl)
        grads = torch.autograd.grad(total, trainer.state_tensors(), materialize_grads=True)
        outs.append((total.item(), loss.item(), align.item(), grads))
    loss_err = abs(outs[0][0] - outs[1][0]) / abs(outs[1][0])
    errs = grad_errors(tr.state_names, outs[0][3], outs[1][3])
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    print(f"  train step at batch 32, kernels vs plain versions on the card: loss "
          f"{outs[0][0]:.6f} vs {outs[1][0]:.6f} (criterion {outs[0][1]:.6f}, KL {outs[0][2]:.6f}), "
          f"relative err {loss_err:.3e}; {len(errs)} gradient tensors, max normalised err "
          f"{worst[0][1]:.3e} (tol {TRAIN_TOL:g}); largest: "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst), flush=True)
    require(np.isfinite(outs[0][0]) and all(torch.isfinite(g).all().item() for g in outs[0][3]),
            "train step on the kernels: non-finite loss or gradient")
    require(loss_err <= TRAIN_TOL, f"train-step loss differs from the plain path: {loss_err:.3e}")
    require(worst[0][1] <= TRAIN_TOL, f"train-step gradient {worst[0][0]} differs: {worst[0][1]:.3e}")
    del outs

    # 2. launches of one step, by counter and by profiler
    lr = (1e-4, 1e-5)
    _build.reset_launches()
    tr.train_step(src, tgt, kl, *lr)
    torch.cuda.synchronize()
    step_launches = dict(_build.LAUNCHES)
    print(f"  launches of one train step (counters): {step_launches}", flush=True)
    require(step_launches == LAUNCHES_PER_STEP,
            f"one train step launched {step_launches}, expected {LAUNCHES_PER_STEP}")
    device_us, by_name = traced_launches(torch, lambda: tr.train_step(src, tgt, kl, *lr),
                                         LAUNCHES_PER_STEP, "one train step at batch 32")

    # 3. step time, kernels against plain
    step_ms = time_ms(lambda: tr.train_step(src, tgt, kl, *lr), reps=10)
    plain_ms = time_ms(lambda: plain.train_step(src, tgt, kl, *lr), reps=10)
    by_kernel = {k: sum(us for name, us in by_name.items()
                        if any(sym in name for sym in KERNEL_NAMES[k])) / 1e3
                 for k in KERNEL_NAMES}
    print(f"  train step at batch 32 (CUDA events, median of 10): kernels {step_ms:.3f} ms "
          f"({32e3 / step_ms:.1f} samples/s), plain {plain_ms:.3f} ms "
          f"({32e3 / plain_ms:.1f} samples/s); device time in the trace {device_us / 1e3:.3f} ms "
          f"(idle share {1 - device_us / 1e3 / step_ms:.1%} of the event-timed step); by kernel "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in by_kernel.items())
          + f", other {device_us / 1e3 - sum(by_kernel.values()):.3f} ms", flush=True)
    del plain

    # 4. a short two-phase train (one main, one finetune epoch), then serve
    # its best checkpoint
    fresh = Trainer(cfg, data=data, adj_matrix=adj, sc_matrix=sc, device=dev)
    n_steps = sum(1 for _ in fresh.train_dataset.batch_starts(cfg.batch_size, drop_last=True))
    n_val = -(-len(fresh.val_dataset) // cfg.batch_size)
    n_test = -(-len(fresh.test_dataset) // cfg.batch_size)
    _build.reset_launches()
    t0 = time.perf_counter()
    results = fresh.train()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    fwd_batches = 2 * n_val + n_test
    expected = {k: 2 * n_steps * LAUNCHES_PER_STEP[k] + fwd_batches * LAUNCHES_PER_BATCH[k]
                for k in LAUNCHES_PER_STEP}
    with open(Path(fresh.save_path) / "metrics.jsonl") as f:
        scalars = [json.loads(line) for line in f]
    train_losses = [r["train/loss"] for r in scalars if "train/loss" in r]
    eval_losses = [r["eval/loss"] for r in scalars if "eval/loss" in r]
    print(f"  Trainer.train(): 1 main + 1 finetune epoch of {n_steps} steps, {n_val} eval and "
          f"{n_test} test batches in {secs:.1f} s (host clock); train losses {train_losses}, "
          f"eval losses {eval_losses}; test MAE {results['mae']:.4f} RMSE {results['rmse']:.4f} "
          f"MAPE {results['mape']:.4f}; launches {launches}", flush=True)
    require(len(train_losses) == 2 and all(np.isfinite(train_losses + eval_losses)),
            "the two-epoch train has a non-finite or missing loss")
    require(all(np.isfinite(results[k]) for k in ("mae", "rmse", "mape")),
            "the two-epoch train's test metrics are not finite")
    require(launches == expected, f"Trainer.train() launched {launches}, expected {expected}")

    pred = Predictor.from_checkpoint(cfg, fresh.save_path, adj, sc, batch_size=32, device=dev)
    test_starts = next(fresh.test_dataset.batch_starts(32))
    windows = fresh.windows(test_starts)[0].cpu().numpy()
    _build.reset_launches()
    served = pred(windows)
    torch.cuda.synchronize()
    served_launches = dict(_build.LAUNCHES)
    want = fresh.predict_idx(test_starts)[..., 0].cpu().numpy()
    serve_err = np.abs(served - want).max() / np.abs(want).max()
    print(f"  Predictor.from_checkpoint(epoch_best) served {served.shape}, launches "
          f"{served_launches}, vs the trainer's own forecast: normalised err {serve_err:.3e}",
          flush=True)
    require(served.shape == (32, n, cfg.tgt_len) and np.isfinite(served).all(),
            "the checkpoint's Predictor output is not finite or of the wrong shape")
    require(served_launches == LAUNCHES_PER_BATCH,
            f"the checkpoint's Predictor launched {served_launches}")
    require(serve_err <= 1e-5, f"the checkpoint serves other forecasts ({serve_err:.3e})")
    shutil.rmtree(save_dir, ignore_errors=True)
    return launches


def main():
    if not (HERE / "paddlexde_tpu_torch" / "__init__.py").is_file():
        raise SmokeFailure(f"paddlexde_tpu_torch/ not found beside {Path(__file__).name}")
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: this script needs a CUDA card")
    sys.path.insert(0, str(HERE))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    card = card_line()
    print(f"card: {card}", flush=True)
    from paddlexde_tpu_torch.ops import _build

    secs = _build.build_all()
    print(f"kernels built in {secs:.1f} s", flush=True)
    build_report()
    kernels = kernel_phase(torch, dev)
    serve_launches = predictor_phase(torch, dev)
    train_launches = train_phase(torch, dev)
    launches = {k: serve_launches[k] + train_launches[k] for k in kernels}
    for name in kernels:
        require(launches[name] > 0, f"{name} was never launched on the main paths")
    print(card)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k][0], "replaces": SOURCES[k][1],
         "launches": launches[k], "max_abs_err": v["err"], "ms": v["ms"],
         "plain_ms": v["plain_ms"], "bound_ms": v["bound3"][0], "bound_by": v["bound3"][1],
         "library_ms": None}
        for k, v in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
