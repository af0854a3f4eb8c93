#!/usr/bin/env python3
"""Drive the PyTorch port of D3STN serving on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds the three hand-written Hopper kernels from ``paddlexde_tpu_torch/
ops/csrc``, holds each against its plain PyTorch version at the PEMS08
shapes (TF32 off), serves PEMS08-width ``Predictor`` requests (random
weights from a seeded generator) through the kernels and against the same
Predictor forced to the plain versions, checks the launch counts by the
wrappers' counters and by a ``torch.profiler`` trace, and prints:

- the card's name and power limit (``nvidia-smi``);
- one JSON line ``{"kernels": [...]}`` with each kernel's launches on the
  main path, error, time, bound, plain-version time and library time;
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

TOL = {"spline": 1e-5, "gcn_fwd": 1e-4, "attn_fwd": 1e-4}
PREDICTOR_TOL = 5e-4
LAUNCHES_PER_BATCH = {"spline": 2, "gcn_fwd": 4, "attn_fwd": 6}
KERNEL_NAMES = {  # CUDA symbol substrings in a profiler trace
    "spline": "hermite_gather_kernel",
    "gcn_fwd": "gcn_fwd_",  # gcn_fwd_d128_tiled_kernel (D=128) or gcn_fwd_kernel
    "attn_fwd": "attn_fwd_",  # attn_fwd_d3stn_kernel (D3STN shape) or attn_fwd_kernel
}
SOURCES = {
    "spline": ("paddlexde_tpu_torch/ops/csrc/spline.cu", "paddlexde_tpu/ops/spline_pallas.py:84"),
    "gcn_fwd": ("paddlexde_tpu_torch/ops/csrc/gcn.cu", "paddlexde_tpu/ops/gcn_pallas.py:54"),
    "attn_fwd": ("paddlexde_tpu_torch/ops/csrc/attn.cu", "paddlexde_tpu/ops/attn_pallas.py:248"),
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


# --------------------------------------------------------------------------
# phase 1: every kernel against its plain version at the PEMS08 shapes
# --------------------------------------------------------------------------


def check_spline(torch, dev, gen):
    from paddlexde_tpu_torch.ops import spline
    from paddlexde_tpu_torch.ops.timing import bound_ms, device_ms, time_ms

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
    ms = device_ms(lambda: spline.gather_eval_kernel(series, t, q), KERNEL_NAMES["spline"])
    wrapper_ms = time_ms(lambda: spline.gather_eval_kernel(series, t, q))
    plain_ms = time_ms(lambda: spline.gather_eval_plain(series, t, q))
    idx, _, _ = spline._prep(series, t, q)
    rows_read = set()
    for i in idx.tolist():
        rows_read.update({i, i + 1, min(i + 2, t_len - 1)})
    n_bytes = 4 * (b * n * d * len(rows_read) + b * n * q.numel() * d + t_len + q.numel())
    n_flops = 11 * b * n * q.numel() * d
    return dict(err=max(errs), ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                bound=bound_ms(n_bytes, n_flops), shape=f"series [{b},{n},{t_len},{d}], L={q.numel()}")


def check_gcn(torch, dev, gen):
    from paddlexde_tpu_torch.ops import gcn
    from paddlexde_tpu_torch.ops.timing import bound_ms, device_ms, gcn_work, time_ms

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
    ms = device_ms(lambda: gcn.gcn_spatial_mix_kernel(x, gate, scale2), KERNEL_NAMES["gcn_fwd"])
    wrapper_ms = time_ms(lambda: gcn.gcn_spatial_mix_kernel(x, gate, scale2))
    plain_ms = time_ms(lambda: gcn.gcn_spatial_mix_plain(x, gate, scale2))
    return dict(err=err, err64=err64, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                bound=bound_ms(*gcn_work(b, n, t_len, d)),
                shape=f"x [{b},{n},{t_len},{d}], gate [{n},{n}]")


def check_attn(torch, dev, gen):
    from paddlexde_tpu_torch.ops import attn
    from paddlexde_tpu_torch.ops.timing import attn_work, bound_ms, device_ms, time_ms

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
        times.append(device_ms(lambda: attn.fused_temporal_attention_kernel(*args),
                               KERNEL_NAMES["attn_fwd"]))
        wrapper_times.append(time_ms(lambda: attn.fused_temporal_attention_kernel(*args)))
        plain_times.append(time_ms(lambda: attn.fused_temporal_attention_plain(*args)))
    return dict(err=max(errs), err64=max(errs64), ms=statistics.mean(times),
                wrapper_ms=statistics.mean(wrapper_times),
                plain_ms=statistics.mean(plain_times),
                bound=bound_ms(*attn_work(b, n, t_len, d, heads, ks)),
                per_flags=list(zip(errs, times, plain_times)),
                shape=f"[{b},{n},{t_len},{d}], H={heads}, K={ks}, 3 flag sets")


def kernel_phase(torch, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for name, fn in (("spline", check_spline), ("gcn_fwd", check_gcn), ("attn_fwd", check_attn)):
        res = fn(torch, dev, gen)
        print(f"kernel {name} ({res['shape']}): max_abs_err(normalised)={res['err']:.3e} "
              f"(tol {TOL[name]:g}) kernel {res['ms']:.4f} ms (device, profiler), wrapper "
              f"{res['wrapper_ms']:.4f} ms, plain {res['plain_ms']:.4f} ms (CUDA events), "
              f"bound {res['bound'][0]:.4f} ms by {res['bound'][1]}, "
              f"launches per Predictor batch {LAUNCHES_PER_BATCH[name]}", flush=True)
        if "err64" in res:
            print(f"  vs the plain version in float64: {res['err64']:.3e}", flush=True)
        for flags_res in res.get("per_flags", ()):
            print(f"  attn flag set: err {flags_res[0]:.3e}, kernel {flags_res[1]:.4f} ms (device), "
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

    # a trace can drop a launch record (seen once in a 10-launch trace), never
    # add one: up to 3 traced batches, the first with every count exact passes
    for attempt in range(3):
        traced, device_us, by_name = trace_batch(torch, pred, src)
        print(f"  profiler, one batch of 32 (trace {attempt + 1}): kernel launches {traced}, "
              f"device time {device_us / 1e3:.3f} ms in {len(by_name)} kernel names", flush=True)
        for key, per_batch in LAUNCHES_PER_BATCH.items():
            require(traced[key] <= per_batch,
                    f"profiler shows {traced[key]} {key} launches in one batch, expected {per_batch}")
        if traced == LAUNCHES_PER_BATCH:
            break
    require(traced == LAUNCHES_PER_BATCH,
            f"profiler shows launches {traced} in one batch, expected {LAUNCHES_PER_BATCH}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"    {us / 1e3:9.4f} ms  {name[:100]}", flush=True)
    return launches


def trace_batch(torch, pred, src):
    """Kernel launches by name, total device time (us) and device time per
    kernel name, from a profiler trace of one Predictor.forward."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pred.forward(src)
        torch.cuda.synchronize()
    traced = {k: 0 for k in KERNEL_NAMES}
    device_us, by_name = 0.0, {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        device_us += evt.device_time
        by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.device_time
        for key, symbol in KERNEL_NAMES.items():
            if symbol in evt.name:
                traced[key] += 1
    return traced, device_us, by_name


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
    kernels = kernel_phase(torch, dev)
    launches = predictor_phase(torch, dev)
    for name in kernels:
        require(launches[name] > 0, f"{name} was never launched on the main path")
    print(card)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k][0], "replaces": SOURCES[k][1],
         "launches": launches[k], "max_abs_err": v["err"], "ms": v["ms"],
         "plain_ms": v["plain_ms"], "bound_ms": v["bound"][0], "bound_by": v["bound"][1],
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
