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

For comparing two trees of the repo bit for bit, the bfloat16 kernels K2
bf16, K4 bf16 and K5 bf16 also give a digest of their outputs on the seeded
inputs (``bits``): K2 bf16's over x float32 and x bfloat16 (each form held
and timed; the bfloat16-x form under ``x_bf16``), K4 bf16's and K5 bf16's
over the three flag sets with and without a dropout-0.1 keep mask. The
attention kernels also give their device time by kernel (``by_kernel``; K5
bf16's conv stage, the launches of its conv kernels, as ``conv_ms``), and
at PEMS08 the bfloat16 ``Trainer.train_step``'s and ``Predictor.forward``'s
device time (``bf16_model``). To run a parent tree under the same harness,
copy this file and ``ops/timing.py`` into it.

All seven shipped configurations run (HZME_INFLOW and HZME_OUTFLOW share a
shape; each draws its own inputs). A kernel whose launch records the
profiler keeps losing (``timing.ProfilerMiss``; seen at PEMS07) is reported
as ``{"untimed": reason}`` after its checks have passed, and K2 bf16 keeps
its ``bits``; a failed check still ends the run. Prints the card line, one line per
configuration, and a JSON list of the measurements as the last line. Exits
non-zero when a kernel disagrees.
"""

from __future__ import annotations

import hashlib
import json
import math
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..models.d3stn.config import load_config
from . import _build, attn, gcn
from .compare import bf16_errors
from .timing import (
    ProfilerMiss,
    attn_bwd_work,
    attn_work,
    bound_3xtf32_ms,
    bound_bf16_ms,
    bound_ms,
    device_ms,
    device_ms_by_kernel,
    device_ms_total,
    gcn_bwd_work,
    gcn_work,
    time_ms,
)

CONFIGS = ("SYNTH", "HZME_INFLOW", "HZME_OUTFLOW", "PEMS08", "PEMS04", "PEMS03", "PEMS07")
BATCH, T_LEN = 32, 12
TOL = 1e-4
# the bfloat16 attention backward against its plain version (chip_smoke.py)
ATTN_BWD_BF16_TOL = 2e-3
FLAG_SETS = ((False, False, False), (True, True, True), (True, False, False))


def _norm_err(got, want):
    scale = want.abs().max().item()
    return (got - want).abs().max().item() / (scale if scale > 0 else 1.0)


def _bounds(work):
    return {"bound_ms": bound_ms(work)[0], "bound3_ms": bound_3xtf32_ms(work)[0]}


def _timed(fn, *args):
    """fn(*args), or ``{"untimed": reason}`` where the profiler kept losing
    launch records of the kernel (its checks had passed; a failed check
    still raises)."""
    try:
        return fn(*args)
    except ProfilerMiss as exc:
        print(f"{args[0]}: {fn.__name__} not timed: {exc}", file=sys.stderr, flush=True)
        return {"untimed": str(exc)}


def _fmt(name, r):
    if "untimed" in r:
        return f"{name} not timed"
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
    if "untimed" in r:
        return f"{name} not timed" + (f", bits {r['bits']}" if "bits" in r else "")
    conv = f", conv stage {r['conv_ms']:.4f} ms" if "conv_ms" in r else ""
    x16 = (f", x bfloat16 {r['x_bf16']['ms']:.4f} ms (bound {r['x_bf16']['bound16_ms']:.4f})"
           if "x_bf16" in r else "")
    bits = f", bits {r['bits']}" if "bits" in r else ""
    return (f"{name} {r['ms']:.4f} ms (err {r['err']:.2e}){conv}, plain {r['plain_ms']:.4f} ms, "
            f"bfloat16 bound {r['bound16_ms']:.4f} ms{x16}{bits}")


def _digest(outputs):
    """The first 16 hex digits of a SHA-256 of the output tensors' bytes."""
    h = hashlib.sha256()
    for t in outputs:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _keep_mask(n, heads, gen, dev):
    keep = 0.9
    draw = torch.rand(BATCH, n, T_LEN, heads * T_LEN, generator=gen, device=dev)
    return (draw < keep).float() / keep


def _by_kernel(runs, symbol):
    """Each kernel's device ms by short name (no namespace, no template
    arguments), the mean over ``runs``; a kernel that a call launches twice
    counts both launches."""
    out = {}
    for run in runs:
        for name, ms in device_ms_by_kernel(run, symbol).items():
            short = re.search(r"\w*" + symbol + r"\w*", name).group(0)
            out[short] = out.get(short, 0.0) + ms / len(runs)
    return out


def _gcn_bf16(name, n, d, gen, dev):
    """K2 bf16 with x float32 (as D3STN passes it; the top-level keys) and
    with x bfloat16 (``x_bf16``), and a digest of both outputs (``bits``)."""
    x = torch.randn(BATCH, n, T_LEN, d, generator=gen, device=dev)
    gate = 0.5 * torch.rand(n, n, generator=gen, device=dev)
    scale2 = 1.0 / math.sqrt(d)
    forms = []
    for xs in (x, x.to(torch.bfloat16)):
        run = lambda xs=xs: gcn.gcn_spatial_mix_bf16_kernel(xs, gate, scale2)  # noqa: E731
        plain = lambda xs=xs: gcn.gcn_spatial_mix_plain(xs, gate, scale2, "bfloat16")  # noqa: E731
        out = run()
        forms.append((xs, run, plain, out, _bf16_check(name, f"GCN (x {xs.dtype})", out, plain())))
    # the digest is kept where the profiler cannot time the kernel
    res = {"bits": _digest([f[3] for f in forms])}
    try:
        for xs, run, plain, _, err in forms:
            r = {"err": err, "ms": device_ms(run, "gcn_bf16_"), "plain_ms": time_ms(plain),
                 "bound16_ms": bound_bf16_ms(gcn_work(BATCH, n, T_LEN, d, xs.element_size(),
                                                      2))[0]}
            if xs is x:
                res.update(r)
            else:
                res["x_bf16"] = r
    except ProfilerMiss as exc:
        print(f"{name}: gcn_bf16 not timed: {exc}", file=sys.stderr, flush=True)
        res["untimed"] = str(exc)
    return res


def _attn_bf16(name, n, d, heads, ks, gen, dev):
    mq, mk, vs = (torch.randn(BATCH, n, T_LEN, d, generator=gen, device=dev) for _ in range(3))
    lim = math.sqrt(6.0 / (2 * ks * d))
    weights = []
    for _ in range(4):
        weights.append((2 * torch.rand(ks, d, d, generator=gen, device=dev) - 1) * lim)
        weights.append(0.1 * torch.randn(d, generator=gen, device=dev))
    mask = _keep_mask(n, heads, gen, dev)
    errs, runs, plain_times, outputs = [], [], [], []
    for flags in FLAG_SETS:
        args = (mq, mk, vs, *weights, *flags, heads)
        run = lambda: attn.fused_temporal_attention_bf16_kernel(*args)  # noqa: E731
        plain = lambda: attn.fused_temporal_attention_plain(*args, "bfloat16")  # noqa: E731
        outputs += [run(), attn.fused_temporal_attention_bf16_kernel(*args, dropout_mask=mask)]
        errs.append(_bf16_check(name, "attention", outputs[-2], plain()))
        runs.append(run)
        plain_times.append(time_ms(plain))
    by_kernel = _by_kernel(runs, "attn_bf16_")
    return {"err": max(errs), "ms": sum(by_kernel.values()), "plain_ms": sum(plain_times) / 3,
            "bound16_ms": bound_bf16_ms(attn_work(BATCH, n, T_LEN, d, heads, ks, 4, 2))[0],
            "by_kernel": by_kernel, "bits": _digest(outputs)}


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
    mask = _keep_mask(n, heads, gen, dev)
    errs, runs, plain_times, digest = [], [], [], hashlib.sha256()
    for flags in FLAG_SETS:
        args = (*acts, *weights, g, *flags, heads)
        run = lambda: attn.fused_temporal_attention_bwd_bf16_kernel(*args)  # noqa: E731
        plain = lambda: attn.fused_temporal_attention_bwd_plain(*args, "bfloat16")  # noqa: E731
        got = run()
        errs.append(max(attn.bwd_errors(got, plain())))
        digest.update(_digest(got).encode())
        digest.update(_digest(attn.fused_temporal_attention_bwd_bf16_kernel(
            *args, dropout_mask=mask)).encode())
        del got
        runs.append(run)
        plain_times.append(time_ms(plain, reps=5))
    if max(errs) > ATTN_BWD_BF16_TOL:
        raise RuntimeError(f"{name}: bfloat16 attention backward error {max(errs):.3e} > "
                           f"{ATTN_BWD_BF16_TOL:g}")
    by_kernel = _by_kernel(runs, "attn_bwd_bf16_")
    return {"err": max(errs), "ms": sum(by_kernel.values()), "plain_ms": sum(plain_times) / 3,
            "bound16_ms": bound_bf16_ms(attn_bwd_work(BATCH, n, T_LEN, d, heads, ks, 4, 2))[0],
            "conv_ms": sum(ms for k, ms in by_kernel.items() if "_conv_kernel" in k),
            "by_kernel": by_kernel, "bits": digest.hexdigest()[:16]}


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


def _bf16_model(cfg_path, dev):
    """Device ms of one bfloat16 ``Trainer.train_step`` and one
    ``Predictor.forward`` at batch 32 on seeded synthetic traffic."""
    from ..models.d3stn import Predictor, Trainer, synthetic_traffic_npz

    rng = np.random.default_rng(0)
    res = {}
    with tempfile.TemporaryDirectory() as save_dir:
        cfg = load_config(cfg_path, batch_size=BATCH, compute_dtype="bfloat16", train_epochs=1,
                          finetune_epochs=0, save_dir=save_dir)
        n = cfg.num_nodes
        a = rng.random((n, n))
        sc = ((a + a.T) / 2).astype(np.float32)
        adj = (rng.random((n, n)) < 0.03).astype(np.float32)
        adj = np.maximum(adj, adj.T)
        tr = Trainer(cfg, data=synthetic_traffic_npz(num_nodes=n, seq_len=288 * 14),
                     adj_matrix=adj, sc_matrix=sc, device=dev)
        starts = next(tr.train_dataset.batch_starts(cfg.batch_size, shuffle=True, seed=cfg.seed))
        src, tgt = tr.windows(starts)
        res["step_ms"] = device_ms_total(lambda: tr.train_step(src, tgt, 1.0, 1e-4, 1e-5))
        del tr
    enc = (np.arange(12) + rng.random(12)).astype(np.float32)
    dec = (cfg.his_len - 1 - 1.5 * rng.random(cfg.tgt_len)).astype(np.float32)
    pred = Predictor(cfg, None, enc, dec, adj, sc, batch_size=BATCH, device=dev,
                     generator=torch.Generator().manual_seed(0))
    pred.warmup()
    steps = np.arange(cfg.his_len)
    value = 0.5 * np.sin(2 * np.pi * steps / 288 + rng.uniform(0, 6.28, (BATCH, n, 1)))
    win = np.stack([value, np.broadcast_to((steps // 288) % 7, value.shape),
                    np.broadcast_to(steps % 288, value.shape)], axis=-1).astype(np.float32)
    win = torch.as_tensor(win).to(dev)
    res["serve_ms"] = device_ms_total(lambda: pred.forward(win))
    return res


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
        g = _timed(_gcn, name, n, d, gen, dev)
        a = _timed(_attn, name, n, d, heads, ks, gen, dev)
        gb = _timed(_gcn_bwd, name, n, d, gen, dev)
        torch.cuda.empty_cache()
        ab = _timed(_attn_bwd, name, n, d, heads, ks, gen, dev)
        torch.cuda.empty_cache()
        g16 = _gcn_bf16(name, n, d, gen, dev)
        a16 = _timed(_attn_bf16, name, n, d, heads, ks, gen, dev)
        gb16 = _timed(_gcn_bwd_bf16, name, n, d, gen, dev)
        torch.cuda.empty_cache()
        ab16 = _timed(_attn_bwd_bf16, name, n, d, heads, ks, gen, dev)
        print(f"{name} [B={BATCH}, N={n}, T={T_LEN}, D={d}, H={heads}]: "
              + "; ".join((_fmt(f"gcn {g.get('kernel', '')}", g),
                           _fmt(f"attn {a.get('kernel', '')}", a),
                           _fmt(f"attn {a.get('kernel', '')} dropout", a.get("dropout", a)),
                           _fmt("gcn_bwd", gb), _fmt("attn_bwd", ab), _fmt16("gcn_bf16", g16),
                           _fmt16("attn_bf16", a16), _fmt16("gcn_bwd_bf16", gb16),
                           _fmt16("attn_bwd_bf16", ab16))), flush=True)
        rows.append({"config": name, "n": n, "d": d, "heads": heads, "gcn": g, "attn": a,
                     "gcn_bwd": gb, "attn_bwd": ab, "gcn_bf16": g16, "attn_bf16": a16,
                     "gcn_bwd_bf16": gb16, "attn_bwd_bf16": ab16})
        torch.cuda.empty_cache()
        if name == "PEMS08":
            rows[-1]["bf16_model"] = _bf16_model(str(root / "examples" / "configs" / "PEMS08.json"),
                                                 dev)
            print(f"PEMS08 bfloat16 device ms: train step {rows[-1]['bf16_model']['step_ms']:.4f}, "
                  f"served batch {rows[-1]['bf16_model']['serve_ms']:.4f}", flush=True)
            torch.cuda.empty_cache()
    print(json.dumps(rows))


if __name__ == "__main__":
    try:
        main()
    except RuntimeError as exc:
        print(f"sweep: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
