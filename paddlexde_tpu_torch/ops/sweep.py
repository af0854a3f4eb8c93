"""Kernel times across the configurations the repo ships, on one CUDA card.

Run from the repository root::

    python -m paddlexde_tpu_torch.ops.sweep

For each configuration in ``examples/configs`` at batch 32 and T=12, the
GCN kernels (forward K2, backward K3) and the attention kernels (forward
K4, backward K5) are held against their plain PyTorch versions (normalised
max-abs error <= 1e-4, TF32 off; the attention gradients by
``attn.bwd_errors``) and timed: device time of one call (profiler trace), the
plain version's time (CUDA events) and both bounds of ``ops/timing.py``
(float32 on the CUDA cores, and the products in 3xTF32 on the tensor cores).
The GCN kernels take D=64 and D=128 on the tensor cores (every shipped
configuration), and so does the float32 attention forward
(``attn_fwd_d3stn_kernel``), which is also held and timed in its dropout
form with a dropout-0.1 keep mask against the plain version on the same
mask. The bfloat16 forwards (GCN with x
float32, as D3STN passes it, and attention) are held against their plain
bfloat16 versions (within one bfloat16 ulp at the top binade on at most 1%
of elements, ``ops/compare.py``) and timed against the bfloat16 bound, and
so are the bfloat16 backwards: K5 bf16 against the plain bfloat16 backward
(``attn.bwd_errors`` <= 2e-3) and K3 on a bfloat16 cotangent with its cast
(bit for bit K3 on ``g.float()``).

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
from .compare import bf16_errors
from .timing import (
    attn_bwd_work,
    attn_work,
    bound_3xtf32_ms,
    bound_bf16_ms,
    bound_ms,
    device_ms,
    device_ms_by_kernel,
    gcn_bwd_work,
    gcn_work,
    time_ms,
)

CONFIGS = ("SYNTH", "HZME_OUTFLOW", "PEMS08", "PEMS04", "PEMS03", "PEMS07")
BATCH, T_LEN = 32, 12
TOL = 1e-4
# the bfloat16 attention backward against its plain version (chip_smoke.py)
ATTN_BWD_BF16_TOL = 2e-3


def _norm_err(got, want):
    scale = want.abs().max().item()
    return (got - want).abs().max().item() / (scale if scale > 0 else 1.0)


def _bounds(work):
    return {"bound_ms": bound_ms(work)[0], "bound3_ms": bound_3xtf32_ms(work)[0]}


def _fmt(name, r):
    return (f"{name} {r['ms']:.4f} ms (err {r['err']:.2e}), plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} / 3xTF32 {r['bound3_ms']:.4f} ms")


def _gcn(name, n, d, gen, dev):
    x = torch.randn(BATCH, n, T_LEN, d, generator=gen, device=dev)
    gate = 0.5 * torch.rand(n, n, generator=gen, device=dev)
    scale2 = 1.0 / math.sqrt(d)
    want = gcn.gcn_spatial_mix_plain(x, gate, scale2)
    run = lambda: gcn.gcn_spatial_mix_kernel(x, gate, scale2)  # noqa: E731
    res = {"err": _norm_err(run(), want), "ms": device_ms(run, "gcn_fwd_"),
           "plain_ms": time_ms(lambda: gcn.gcn_spatial_mix_plain(x, gate, scale2)),
           **_bounds(gcn_work(BATCH, n, T_LEN, d)),
           "kernel": "tc" if d in (64, 128) else "generic"}
    if res["err"] > TOL:
        raise RuntimeError(f"{name}: GCN error {res['err']:.3e} > {TOL:g}")
    return res


def _bf16_check(name, kernel, got, want):
    err, ulp, share = bf16_errors(got, want)
    if err > ulp or share > 0.01:
        raise RuntimeError(f"{name}: bfloat16 {kernel} error {err:.3e} (ulp {ulp:.3e}), "
                           f"{share:.4%} of elements differ")
    return err


def _fmt16(name, r):
    return (f"{name} {r['ms']:.4f} ms (err {r['err']:.2e}), plain {r['plain_ms']:.4f} ms, "
            f"bfloat16 bound {r['bound16_ms']:.4f} ms")


def _gcn_bf16(name, n, d, gen, dev):
    x = torch.randn(BATCH, n, T_LEN, d, generator=gen, device=dev)
    gate = 0.5 * torch.rand(n, n, generator=gen, device=dev)
    scale2 = 1.0 / math.sqrt(d)
    run = lambda: gcn.gcn_spatial_mix_bf16_kernel(x, gate, scale2)  # noqa: E731
    plain = lambda: gcn.gcn_spatial_mix_plain(x, gate, scale2, "bfloat16")  # noqa: E731
    return {"err": _bf16_check(name, "GCN", run(), plain()), "ms": device_ms(run, "gcn_bf16_"),
            "plain_ms": time_ms(plain),
            "bound16_ms": bound_bf16_ms(gcn_work(BATCH, n, T_LEN, d, 4, 2))[0]}


def _attn_bf16(name, n, d, heads, ks, gen, dev):
    mq, mk, vs = (torch.randn(BATCH, n, T_LEN, d, generator=gen, device=dev) for _ in range(3))
    lim = math.sqrt(6.0 / (2 * ks * d))
    weights = []
    for _ in range(4):
        weights.append((2 * torch.rand(ks, d, d, generator=gen, device=dev) - 1) * lim)
        weights.append(0.1 * torch.randn(d, generator=gen, device=dev))
    errs, times, plain_times = [], [], []
    for flags in ((False, False, False), (True, True, True), (True, False, False)):
        args = (mq, mk, vs, *weights, *flags, heads)
        run = lambda: attn.fused_temporal_attention_bf16_kernel(*args)  # noqa: E731
        plain = lambda: attn.fused_temporal_attention_plain(*args, "bfloat16")  # noqa: E731
        errs.append(_bf16_check(name, "attention", run(), plain()))
        times.append(device_ms(run, "attn_bf16_"))
        plain_times.append(time_ms(plain))
    return {"err": max(errs), "ms": sum(times) / 3, "plain_ms": sum(plain_times) / 3,
            "bound16_ms": bound_bf16_ms(attn_work(BATCH, n, T_LEN, d, heads, ks, 4, 2))[0]}


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
            **_bounds(gcn_bwd_work(BATCH, n, T_LEN, d))}


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
            **_bounds(attn_bwd_work(BATCH, n, T_LEN, d, heads, ks))}


def _gcn_bwd_bf16(name, n, d, gen, dev):
    """K3 on a bfloat16 cotangent (with its cast), bit for bit K3 on g.float()."""
    x = torch.randn(BATCH, n, T_LEN, d, generator=gen, device=dev)
    g = torch.randn(BATCH, n, T_LEN, d, generator=gen, device=dev).to(torch.bfloat16)
    gate = 0.5 * torch.rand(n, n, generator=gen, device=dev)
    scale2 = 1.0 / math.sqrt(d)
    run = lambda: gcn.gcn_spatial_mix_bwd_bf16_kernel(x, gate, g, scale2)  # noqa: E731
    plain = lambda: gcn.gcn_spatial_mix_bwd_plain(x, gate, g.float(), scale2)  # noqa: E731
    got = run()
    if not all(torch.equal(a, b) for a, b in
               zip(got, gcn.gcn_spatial_mix_bwd_kernel(x, gate, g.float(), scale2))):
        raise RuntimeError(f"{name}: K3 on a bfloat16 g differs from K3 on g.float()")
    return {"err": max(_norm_err(a, w) for a, w in zip(got, plain())),
            "ms": sum(device_ms_by_kernel(run, "").values()), "plain_ms": time_ms(plain, reps=5),
            "bound16_ms": bound_bf16_ms(gcn_bwd_work(BATCH, n, T_LEN, d, 2))[0]}


def _attn_bwd_bf16(name, n, d, heads, ks, gen, dev):
    acts = [torch.randn(BATCH, n, T_LEN, d, generator=gen, device=dev) for _ in range(4)]
    g = acts.pop().to(torch.bfloat16)
    lim = math.sqrt(6.0 / (2 * ks * d))
    weights = []
    for _ in range(4):
        weights.append((2 * torch.rand(ks, d, d, generator=gen, device=dev) - 1) * lim)
        weights.append(0.1 * torch.randn(d, generator=gen, device=dev))
    errs, times, plain_times = [], [], []
    for flags in ((False, False, False), (True, True, True), (True, False, False)):
        args = (*acts, *weights, g, *flags, heads)
        run = lambda: attn.fused_temporal_attention_bwd_bf16_kernel(*args)  # noqa: E731
        plain = lambda: attn.fused_temporal_attention_bwd_plain(*args, "bfloat16")  # noqa: E731
        errs.append(max(attn.bwd_errors(run(), plain())))
        times.append(device_ms(run, "attn_bwd_bf16_"))
        plain_times.append(time_ms(plain, reps=5))
    if max(errs) > ATTN_BWD_BF16_TOL:
        raise RuntimeError(f"{name}: bfloat16 attention backward error {max(errs):.3e} > "
                           f"{ATTN_BWD_BF16_TOL:g}")
    return {"err": max(errs), "ms": sum(times) / 3, "plain_ms": sum(plain_times) / 3,
            "bound16_ms": bound_bf16_ms(attn_bwd_work(BATCH, n, T_LEN, d, heads, ks, 4, 2))[0]}


def _attn(name, n, d, heads, ks, gen, dev):
    mq, mk, vs = (torch.randn(BATCH, n, T_LEN, d, generator=gen, device=dev) for _ in range(3))
    lim = math.sqrt(6.0 / (2 * ks * d))
    weights = []
    for _ in range(4):
        weights.append((2 * torch.rand(ks, d, d, generator=gen, device=dev) - 1) * lim)
        weights.append(0.1 * torch.randn(d, generator=gen, device=dev))
    keep = 0.9
    mask = (torch.rand(BATCH, n, T_LEN, heads * T_LEN, generator=gen, device=dev) < keep).float()
    mask /= keep
    res = {key: [] for key in ("err", "ms", "plain_ms", "drop_err", "drop_ms", "drop_plain_ms")}
    for flags in ((False, False, False), (True, True, True), (True, False, False)):
        args = (mq, mk, vs, *weights, *flags, heads)
        for drop, m in (("", None), ("drop_", mask)):
            run = lambda: attn.fused_temporal_attention_kernel(*args, m)  # noqa: E731
            plain = lambda: attn.fused_temporal_attention_plain(*args, "float32", m)  # noqa: E731
            res[drop + "err"].append(_norm_err(run(), plain()))
            res[drop + "ms"].append(device_ms(run, "attn_fwd_"))
            res[drop + "plain_ms"].append(time_ms(plain))
    if max(res["err"] + res["drop_err"]) > TOL:
        raise RuntimeError(f"{name}: attention error {max(res['err'] + res['drop_err']):.3e} > "
                           f"{TOL:g}")
    route = attn.f32_fwd_route(mq, mk, weights[0], False, False, False, heads)
    drop_bounds = _bounds(attn_work(BATCH, n, T_LEN, d, heads, ks, dropout=True))
    return {"err": max(res["err"]), "ms": sum(res["ms"]) / 3,
            "plain_ms": sum(res["plain_ms"]) / 3,
            **_bounds(attn_work(BATCH, n, T_LEN, d, heads, ks)), "kernel": route,
            "dropout": {"err": max(res["drop_err"]), "ms": sum(res["drop_ms"]) / 3,
                        "plain_ms": sum(res["drop_plain_ms"]) / 3, **drop_bounds}}


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
        torch.cuda.empty_cache()
        g16 = _gcn_bf16(name, n, d, gen, dev)
        a16 = _attn_bf16(name, n, d, heads, ks, gen, dev)
        gb16 = _gcn_bwd_bf16(name, n, d, gen, dev)
        torch.cuda.empty_cache()
        ab16 = _attn_bwd_bf16(name, n, d, heads, ks, gen, dev)
        print(f"{name} [B={BATCH}, N={n}, T={T_LEN}, D={d}, H={heads}]: "
              + "; ".join((_fmt(f"gcn {g['kernel']}", g), _fmt(f"attn {a['kernel']}", a),
                           _fmt(f"attn {a['kernel']} dropout", a["dropout"]),
                           _fmt("gcn_bwd", gb), _fmt("attn_bwd", ab), _fmt16("gcn_bf16", g16),
                           _fmt16("attn_bf16", a16), _fmt16("gcn_bwd_bf16", gb16),
                           _fmt16("attn_bwd_bf16", ab16))), flush=True)
        rows.append({"config": name, "n": n, "d": d, "heads": heads, "gcn": g, "attn": a,
                     "gcn_bwd": gb, "attn_bwd": ab, "gcn_bf16": g16, "attn_bf16": a16,
                     "gcn_bwd_bf16": gb16, "attn_bwd_bf16": ab16})
        torch.cuda.empty_cache()
    print(json.dumps(rows))


if __name__ == "__main__":
    try:
        main()
    except RuntimeError as exc:
        print(f"sweep: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
