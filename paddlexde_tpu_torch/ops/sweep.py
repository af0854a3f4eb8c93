"""Kernel times across the configurations the repo ships, on one CUDA card.

Run from the repository root::

    python -m paddlexde_tpu_torch.ops.sweep

For each configuration in ``examples/configs`` at batch 32 and T=12, the
GCN kernels (forward K2, backward K3) and the attention kernels (forward
K4, backward K5) are held against their plain PyTorch versions (normalised
max-abs error <= 1e-4, TF32 off; the attention gradients by
``attn.bwd_errors``) and timed: device time of one call (profiler trace), the
plain version's time (CUDA events) and the bound (``ops/timing.py``).
Forward shapes other than D3STN's at D=128 (SYNTH) take the generic
kernels; the backward kernels take D=64 and D=128.

Prints the card line, one line per configuration, and a JSON list of the
measurements as the last line. Exits non-zero when a kernel disagrees.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

import torch

from ..models.d3stn.config import load_config
from . import _build, attn, gcn
from .timing import attn_bwd_work, attn_work, bound_ms, device_ms, gcn_bwd_work, gcn_work, time_ms

CONFIGS = ("SYNTH", "HZME_OUTFLOW", "PEMS08", "PEMS04", "PEMS03", "PEMS07")
BATCH, T_LEN = 32, 12
TOL = 1e-4


def _norm_err(got, want):
    scale = want.abs().max().item()
    return (got - want).abs().max().item() / (scale if scale > 0 else 1.0)


def _gcn(name, n, d, gen, dev):
    x = torch.randn(BATCH, n, T_LEN, d, generator=gen, device=dev)
    gate = 0.5 * torch.rand(n, n, generator=gen, device=dev)
    scale2 = 1.0 / math.sqrt(d)
    want = gcn.gcn_spatial_mix_plain(x, gate, scale2)
    run = lambda: gcn.gcn_spatial_mix_kernel(x, gate, scale2)  # noqa: E731
    res = {"err": _norm_err(run(), want), "ms": device_ms(run, "gcn_fwd_"),
           "plain_ms": time_ms(lambda: gcn.gcn_spatial_mix_plain(x, gate, scale2)),
           "bound_ms": bound_ms(*gcn_work(BATCH, n, T_LEN, d))[0],
           "kernel": "d128" if d == 128 else "generic"}
    if res["err"] > TOL:
        raise RuntimeError(f"{name}: GCN error {res['err']:.3e} > {TOL:g}")
    return res


def _gcn_bwd(name, n, d, gen, dev):
    x, g = (torch.randn(BATCH, n, T_LEN, d, generator=gen, device=dev) for _ in range(2))
    gate = 0.5 * torch.rand(n, n, generator=gen, device=dev)
    scale2 = 1.0 / math.sqrt(d)
    plain = lambda: gcn.gcn_spatial_mix_bwd_plain(x, gate, g, scale2)  # noqa: E731
    run = lambda: gcn.gcn_spatial_mix_bwd_kernel(x, gate, g, scale2)  # noqa: E731
    err = max(_norm_err(a, w) for a, w in zip(run(), plain()))
    if err > TOL:
        raise RuntimeError(f"{name}: GCN backward error {err:.3e} > {TOL:g}")
    return {"err": err, "ms": device_ms(run, "gcn_bwd_"), "plain_ms": time_ms(plain, reps=5),
            "bound_ms": bound_ms(*gcn_bwd_work(BATCH, n, T_LEN, d))[0]}


def _attn_bwd(name, n, d, heads, ks, gen, dev):
    acts = [torch.randn(BATCH, n, T_LEN, d, generator=gen, device=dev) for _ in range(4)]
    lim = math.sqrt(6.0 / (2 * ks * d))
    weights = []
    for _ in range(4):
        weights.append((2 * torch.rand(ks, d, d, generator=gen, device=dev) - 1) * lim)
        weights.append(0.1 * torch.randn(d, generator=gen, device=dev))
    errs, times, plain_times = [], [], []
    for flags in ((False, False, False), (True, True, True), (True, False, False)):
        args = (*acts[:3], *weights, acts[3], *flags, heads)
        run = lambda: attn.fused_temporal_attention_bwd_kernel(*args)  # noqa: E731
        plain = lambda: attn.fused_temporal_attention_bwd_plain(*args)  # noqa: E731
        errs.append(max(attn.bwd_errors(run(), plain())))
        times.append(device_ms(run, "attn_bwd_"))
        plain_times.append(time_ms(plain, reps=5))
    if max(errs) > TOL:
        raise RuntimeError(f"{name}: attention backward error {max(errs):.3e} > {TOL:g}")
    return {"err": max(errs), "ms": sum(times) / 3, "plain_ms": sum(plain_times) / 3,
            "bound_ms": bound_ms(*attn_bwd_work(BATCH, n, T_LEN, d, heads, ks))[0]}


def _attn(name, n, d, heads, ks, gen, dev):
    mq, mk, vs = (torch.randn(BATCH, n, T_LEN, d, generator=gen, device=dev) for _ in range(3))
    lim = math.sqrt(6.0 / (2 * ks * d))
    weights = []
    for _ in range(4):
        weights.append((2 * torch.rand(ks, d, d, generator=gen, device=dev) - 1) * lim)
        weights.append(0.1 * torch.randn(d, generator=gen, device=dev))
    errs, times, plain_times = [], [], []
    for flags in ((False, False, False), (True, True, True), (True, False, False)):
        args = (mq, mk, vs, *weights, *flags, heads)
        run = lambda: attn.fused_temporal_attention_kernel(*args)  # noqa: E731
        errs.append(_norm_err(run(), attn.fused_temporal_attention_plain(*args)))
        times.append(device_ms(run, "attn_fwd_"))
        plain_times.append(time_ms(lambda: attn.fused_temporal_attention_plain(*args)))
    if max(errs) > TOL:
        raise RuntimeError(f"{name}: attention error {max(errs):.3e} > {TOL:g}")
    d3stn = (d, heads, ks) == (128, 8, 3)
    return {"err": max(errs), "ms": sum(times) / 3, "plain_ms": sum(plain_times) / 3,
            "bound_ms": bound_ms(*attn_work(BATCH, n, T_LEN, d, heads, ks))[0],
            "kernel": "d3stn" if d3stn else "generic"}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("sweep: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    _build.build_all()

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    root = Path(__file__).resolve().parents[2]
    rows = []
    for name in CONFIGS:
        cfg = load_config(str(root / "examples" / "configs" / f"{name}.json"))
        n, d, heads, ks = cfg.num_nodes, cfg.d_model, cfg.head, cfg.kernel_size
        g = _gcn(name, n, d, gen, dev)
        a = _attn(name, n, d, heads, ks, gen, dev)
        gb = _gcn_bwd(name, n, d, gen, dev)
        torch.cuda.empty_cache()
        ab = _attn_bwd(name, n, d, heads, ks, gen, dev)
        print(f"{name} [B={BATCH}, N={n}, T={T_LEN}, D={d}, H={heads}]: "
              f"gcn {g['kernel']} {g['ms']:.4f} ms (err {g['err']:.2e}), plain "
              f"{g['plain_ms']:.4f} ms, bound {g['bound_ms']:.4f} ms; "
              f"attn {a['kernel']} {a['ms']:.4f} ms (err {a['err']:.2e}), plain "
              f"{a['plain_ms']:.4f} ms, bound {a['bound_ms']:.4f} ms; "
              f"gcn_bwd {gb['ms']:.4f} ms (err {gb['err']:.2e}), plain {gb['plain_ms']:.4f} ms, "
              f"bound {gb['bound_ms']:.4f} ms; attn_bwd {ab['ms']:.4f} ms (err {ab['err']:.2e}), "
              f"plain {ab['plain_ms']:.4f} ms, bound {ab['bound_ms']:.4f} ms", flush=True)
        rows.append({"config": name, "n": n, "d": d, "heads": heads, "gcn": g, "attn": a,
                     "gcn_bwd": gb, "attn_bwd": ab})
        torch.cuda.empty_cache()
    print(json.dumps(rows))


if __name__ == "__main__":
    try:
        main()
    except RuntimeError as exc:
        print(f"sweep: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
