#!/usr/bin/env python3
"""Drive the PyTorch port of D3STN serving and training on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds the eight hand-written Hopper kernel sources from
``paddlexde_tpu_torch/ops/csrc``, prints the compiler's registers, spills
and shared memory of the GCN and attention kernels and the count of
tensor-core instructions in their libraries, with and without the
attention kernels' dropout instantiations (it fails if one has none, if a
spline or GCN kernel spills, if a float32 K2 or K3 tensor-core kernel has
no HGMMA, if a bfloat16 kernel spills or has no HGMMA, checked by
name for K5 bf16's conv kernel and each of K4 bf16's twelve
instantiations, or if a D = 64 instantiation of the float32 attention
forward, with or without dropout, spills or has no HGMMA), and runs six
phases (PyTorch's
TF32 off throughout, and cuBLAS's reduced-precision bfloat16 sums off; the
float32 GCN and attention kernels run their products in 3xTF32, the
bfloat16 ones in bfloat16):

1. each kernel against its plain PyTorch version at the PEMS08 shapes: the
   history lookup K1 (``check_spline``) on an edge-case query set and on the
   main path's, ``init_lag_anchors``' decoder and encoder lags through the
   pair kernel (one launch, the plain version's bits, the derivative basis
   too), its lag gradient in float32 and float64 (one launch, the same bits
   twice, within SPLINE_BWD_TOL of the plain version) and the pair's lag
   backward traced as that one kernel, with the device time of each beside
   its byte bound for each query set, the launch floor (one elementwise op
   on one element) and the host time per wrapper call; the
   forward kernels against the float32 and float64 plain versions (GCN K2
   within 1e-5 of float64, run twice and required to give the same bits),
   the backward kernels (GCN K3, attention K5) against the float32 and
   float64 plain backward (K3 within 1e-5 of float64), each run twice and
   required to give the same bits, with K3's and K5's device time per
   kernel (K5 bf16's conv stage and weight-gradient stage each beside its
   own bound); the bfloat16 forward kernels (GCN, attention) against their
   plain bfloat16 versions (within one bfloat16 ulp at the top binade, on at
   most 1% of elements) and run twice for the same bits; the bfloat16
   attention backward K5 against the plain bfloat16 backward
   (``attn.bwd_errors`` within ATTN_BWD_BF16_TOL, the parent's route
   printed as a control) and K3 on a bfloat16 cotangent, bit for bit K3 on
   ``g.float()``, both the same bits twice; the dropout forms of K4 and K5
   in float32 and bfloat16 with a dropout-0.1 keep mask against their plain
   versions with the same mask (float32 within TOL, bfloat16 as above), each
   the same bits twice, an all-keep mask giving the no-dropout kernel's
   bits; the float32 attention forward and its dropout form at SYNTH's
   shapes (B 32, N 16, D 64, 4 heads: the tensor-core kernel at D = 64)
   against the float32 and float64 plain versions, the same checks;
2. serving: PEMS08-width ``Predictor`` requests (random weights from a
   seeded generator) through the kernels and against the same Predictor
   forced to the plain versions, in float32 and then in bfloat16
   (``compute_dtype="bfloat16"``: the bfloat16 GCN and attention kernels;
   both bfloat16 forecasts also against the float32 one);
3. training: the PEMS08 config at batch 32 on a synthetic series; one
   ``Trainer`` step on the kernels against one on the plain versions (loss
   and every gradient), the launches of a step by counter and profiler, the
   step time, then a short two-phase ``Trainer.train()`` whose best
   checkpoint a ``Predictor`` serves through the kernels;
4. training in bfloat16 at PEMS08 width and depth, batch 32: one step on
   the kernels against the plain bfloat16 versions, within the plain
   step's distance from the float32 step (loss and every gradient); each
   attention sublayer's backward teacher-forced on the step's inputs and
   cotangent, with the parent's route as a control that must fail; the
   launches of a step by counter and profiler, the step time, then
   BF16_STEPS more steps with a finite loss;
5. training with dropout 0.1 at PEMS08 width and depth, batch 32, in
   float32 and then in bfloat16: one step on the kernels against one on
   the plain versions with the same masks, under the rules of phases 3 and
   4; the launches of a step by counter and profiler (the dropout forms of
   K4 and K5, no GCN kernel: with dropout the GCN runs the JAX model's XLA
   form), the step time, then DROPOUT_STEPS more steps with a finite loss;
6. SYNTH (d_model 64, 4 heads, N 16, 2+2 layers, with_adj) at full width
   and depth, batch 32, random weights: float32 serving against the plain
   Predictor (as phase 2), one float32 train step against the plain step
   (as phase 3) and TRAIN_STEPS more, and the dropout-0.1 steps of phase 5
   in float32 and bfloat16 (the bfloat16 gradients also beside a witness,
   the plain step on the CPU with the same masks); the profiler must show
   the float32 attention forward as ``attn_fwd_d3stn_kernel<64, ...>``.

Launch counts are checked by the wrappers' counters and by ``torch.profiler``
traces. It prints:

- the card's name and power limit (``nvidia-smi``);
- one JSON line ``{"kernels": [...]}`` with each kernel's launches on the
  main paths (serving in float32 and in bfloat16, the two-epoch train, the
  bfloat16 train steps and the dropout train steps, and phase 6's; the
  float32 attention forward and its dropout form at D = 64 are rows of
  their own, with phase 6's launches), error, time, bound
  (the 3xTF32 bound of ``ops/timing.py``, the bfloat16 bound for the
  bfloat16 kernels), plain-version time and library time;
- as the last line, ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the result lines. With no CUDA card, or
without the ``paddlexde_tpu_torch`` package beside this file, it fails too.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

# the lag gradient against its plain version, per query, relative to the
# sum of |g dH/dq| over its terms (the two sum in other orders)
SPLINE_BWD_TOL = {"float32": 1e-5, "float64": 1e-12}
TOL = {"gcn_fwd": 1e-4, "gcn_bwd": 1e-4, "attn_fwd": 1e-4, "attn_bwd": 1e-4}
# the GCN forward and backward (3xTF32 on the tensor cores) against the
# float64 plain versions
GCN_FWD_TOL64 = 1e-5
GCN_BWD_TOL64 = 1e-5
PREDICTOR_TOL = 5e-4
# a bfloat16 kernel against its plain version: within one bfloat16 ulp at the
# top binade (ops/compare.py), on at most this share of elements
BF16_SHARE = 0.01
# the bfloat16 attention backward against its plain bfloat16 version on the
# same inputs: the largest of attn.bwd_errors' 11 normalised errors. The two
# round dq, dk and dv to bfloat16 after float32 sums taken in other orders,
# so a few land one ulp apart and carry it into the input and weight
# gradients
ATTN_BWD_BF16_TOL = 2e-3
# the train step on the kernels against the plain versions on the card:
# loss relative, each gradient tensor normalised max-abs
TRAIN_TOL = 1e-3
# further bfloat16 train steps after the checked one (finite loss)
BF16_STEPS = 8
# the gradients that the model's backward rounds to bfloat16: the bfloat16
# dense layers' weights and biases (flax's transposed products and sums)
BF16_ROUNDED_GRADS = ("encoder_dense.", "decoder_dense.", ".gcn.proj.")
# the dropout rate of phase 1's masks and phase 5's training (the JAX
# package's own bench setting, tools/bench_d3stn.py)
DROPOUT = 0.1
# further dropout train steps after the checked one (finite loss)
DROPOUT_STEPS = 4
# further float32 train steps after the checked one at SYNTH (phase 6)
TRAIN_STEPS = 4
_ZERO = {"spline": 0, "spline_bwd": 0, "gcn_fwd": 0, "gcn_bwd": 0, "attn_fwd": 0, "attn_bwd": 0,
         "gcn_fwd_bf16": 0, "attn_fwd_bf16": 0, "gcn_bwd_bf16": 0, "attn_bwd_bf16": 0,
         "attn_fwd_dropout": 0, "attn_bwd_dropout": 0, "attn_fwd_bf16_dropout": 0,
         "attn_bwd_bf16_dropout": 0}
# K1: one pair forward a batch or step (the decoder and encoder lags), one
# lag gradient (both sets) a step: 1 launch a batch, 2 a step
LAUNCHES_PER_BATCH = {**_ZERO, "spline": 1, "gcn_fwd": 4, "attn_fwd": 6}
LAUNCHES_PER_BATCH_BF16 = {**_ZERO, "spline": 1, "gcn_fwd_bf16": 4, "attn_fwd_bf16": 6}
LAUNCHES_PER_STEP = {**_ZERO, "spline": 1, "spline_bwd": 1, "gcn_fwd": 4, "gcn_bwd": 4,
                     "attn_fwd": 6, "attn_bwd": 6}
LAUNCHES_PER_STEP_BF16 = {**_ZERO, "spline": 1, "spline_bwd": 1, "gcn_fwd_bf16": 4,
                          "attn_fwd_bf16": 6, "gcn_bwd_bf16": 4, "attn_bwd_bf16": 6}
# with dropout the GCN runs the JAX model's XLA form: no K2, no K3
LAUNCHES_PER_STEP_DROPOUT = {**_ZERO, "spline": 1, "spline_bwd": 1, "attn_fwd_dropout": 6,
                             "attn_bwd_dropout": 6}
LAUNCHES_PER_STEP_DROPOUT_BF16 = {**_ZERO, "spline": 1, "spline_bwd": 1,
                                  "attn_fwd_bf16_dropout": 6, "attn_bwd_bf16_dropout": 6}
# CUDA symbol substrings in a profiler trace; one wrapper call launches one
# kernel of each symbol (ops/timing.py's LAUNCHES_PER_CALL: more). K3 on a
# bfloat16 cotangent (counter gcn_bwd_bf16) launches the gcn_bwd kernels: a
# trace counts it under gcn_bwd
KERNEL_NAMES = {
    "spline": ("hermite_gather_kernel",),  # one query set or two
    "spline_bwd": ("hermite_lag_grad_kernel",),
    "gcn_fwd": ("gcn_fwd_",),  # gcn_fwd_tc_kernel (D=64, 128) or gcn_fwd_kernel
    "gcn_bwd": ("gcn_bwd_row_tc_kernel", "gcn_bwd_col_tc_kernel", "gcn_bwd_dgate_kernel"),
    "attn_fwd": ("attn_fwd_wsplit_kernel", "attn_fwd_d3stn_kernel"),  # D3STN's shape
    "attn_bwd": ("attn_bwd_wt_kernel", "attn_bwd_qkv_conv_kernel", "attn_bwd_core_kernel",
                 "attn_bwd_dx_conv_kernel", "attn_bwd_dw_kernel", "attn_bwd_sum_kernel"),
    # the slice kernel up to N = 192, at 129-192 nodes (PEMS08) after
    # bf16(gate); past 192 the two-pass kernel alone
    # (gcn_bf16_fwd_kernel_two_pass)
    "gcn_fwd_bf16": ("gcn_bf16_gate_kernel", "gcn_bf16_fwd_kernel"),
    "attn_fwd_bf16": ("attn_bf16_wcast_kernel", "attn_bf16_fwd_kernel"),
    "attn_bwd_bf16": ("attn_bwd_bf16_wcast_kernel", "attn_bwd_bf16_conv_kernel",
                      "attn_bwd_bf16_core_kernel", "attn_bwd_bf16_dw_kernel",
                      "attn_bwd_bf16_sum_kernel"),
}
# which float32 attention forward ran: the tensor-core kernel at D = 64
# (attn_fwd_d3stn_kernel<64, ...>, SYNTH) or the generic CUDA-core
# attn_fwd_kernel, which no shipped configuration reaches (every trace
# requires 0 of it). Counted in a trace beside KERNEL_NAMES, not in the
# device time by kernel
ROUTE_NAMES = {"attn_fwd_d64": "attn_fwd_d3stn_kernel<64", "attn_fwd_generic": "attn_fwd_kernel<"}
# the dropout forms are instantiations of the same kernels (their last
# template argument, DROP, true): a trace counts them under those kernels
TRACED_AS = {"gcn_bwd_bf16": "gcn_bwd", "attn_fwd_dropout": "attn_fwd",
             "attn_bwd_dropout": "attn_bwd", "attn_fwd_bf16_dropout": "attn_fwd_bf16",
             "attn_bwd_bf16_dropout": "attn_bwd_bf16"}
SOURCES = {
    "spline": ("paddlexde_tpu_torch/ops/csrc/spline.cu", "paddlexde_tpu/ops/spline_pallas.py:84"),
    # the TPU kernel with the derivative basis (the backward of
    # hermite_gather_eval), its product with g and sum folded in
    "spline_bwd": ("paddlexde_tpu_torch/ops/csrc/spline.cu",
                   "paddlexde_tpu/ops/spline_pallas.py:84"),
    "gcn_fwd": ("paddlexde_tpu_torch/ops/csrc/gcn.cu", "paddlexde_tpu/ops/gcn_pallas.py:54"),
    "gcn_bwd": ("paddlexde_tpu_torch/ops/csrc/gcn_bwd.cu", "paddlexde_tpu/ops/gcn_pallas.py:70"),
    "attn_fwd": ("paddlexde_tpu_torch/ops/csrc/attn.cu", "paddlexde_tpu/ops/attn_pallas.py:248"),
    "attn_bwd": ("paddlexde_tpu_torch/ops/csrc/attn_bwd.cu", "paddlexde_tpu/ops/attn_pallas.py:494"),
    "gcn_fwd_bf16": ("paddlexde_tpu_torch/ops/csrc/gcn_bf16.cu", "paddlexde_tpu/ops/gcn_pallas.py:54"),
    "attn_fwd_bf16": ("paddlexde_tpu_torch/ops/csrc/attn_bf16.cu",
                      "paddlexde_tpu/ops/attn_pallas.py:248"),
    "gcn_bwd_bf16": ("paddlexde_tpu_torch/ops/csrc/gcn_bwd.cu", "paddlexde_tpu/ops/gcn_pallas.py:70"),
    "attn_bwd_bf16": ("paddlexde_tpu_torch/ops/csrc/attn_bwd_bf16.cu",
                      "paddlexde_tpu/ops/attn_pallas.py:494"),
    "attn_fwd_dropout": ("paddlexde_tpu_torch/ops/csrc/attn.cu",
                         "paddlexde_tpu/ops/attn_pallas.py:248"),
    "attn_bwd_dropout": ("paddlexde_tpu_torch/ops/csrc/attn_bwd.cu",
                         "paddlexde_tpu/ops/attn_pallas.py:494"),
    "attn_fwd_bf16_dropout": ("paddlexde_tpu_torch/ops/csrc/attn_bf16.cu",
                              "paddlexde_tpu/ops/attn_pallas.py:248"),
    "attn_bwd_bf16_dropout": ("paddlexde_tpu_torch/ops/csrc/attn_bwd_bf16.cu",
                              "paddlexde_tpu/ops/attn_pallas.py:494"),
    "attn_fwd_d64": ("paddlexde_tpu_torch/ops/csrc/attn.cu",
                     "paddlexde_tpu/ops/attn_pallas.py:248"),
    "attn_fwd_dropout_d64": ("paddlexde_tpu_torch/ops/csrc/attn.cu",
                             "paddlexde_tpu/ops/attn_pallas.py:248"),
}
BF16_KERNELS = ("gcn_fwd_bf16", "attn_fwd_bf16")



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


def dropout_tensor_core_counts(sass):
    """``(HMMA + HGMMA, HGMMA)`` in the SASS functions of the attention
    kernels' dropout instantiations: those whose last template argument,
    DROP, is true (mangled ``Lb1EEEv``)."""
    n_tc = n_hgmma = 0
    drop = False
    for line in sass.splitlines():
        if "Function :" in line:
            drop = "Lb1EEEv" in line
        elif drop and ("HMMA" in line or "HGMMA" in line):
            n_tc += 1
            n_hgmma += "HGMMA" in line
    return n_tc, n_hgmma


def hgmma_by_function(sass, symbol):
    """``{SASS function: HGMMA count}`` of the functions whose mangled name
    contains ``symbol``."""
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            if symbol in name:
                counts[name] = 0
        elif name in counts and "HGMMA" in line:
            counts[name] += 1
    return counts


# the mangled name of the float32 attention forward's D = 64 instantiations
ATTN_FWD_D64 = "attn_fwd_d3stn_kernelILi64E"
# kernels that must hold HGMMA in each instantiation, by library, with
# their instantiation counts: K5 bf16's persistent conv kernel (D = 64, 128)
# and K4 bf16 (3 flag sets x D = 64, 128 x DROP), both on the bfloat16
# temporal conv (tc_bf16_conv.cuh); K2 bf16 (D = 64, 128 x x float32,
# bfloat16 x the slice kernel at 1, 2, 3 resident node tiles and the
# two-pass kernel); the float32 GCN's tensor-core kernels, K2 and K3's two
# (D = 64, 128: gcn_tc.cuh's chains)
HGMMA_KERNELS = {"attn_bwd_bf16": (("attn_bwd_bf16_conv_kernel", 2),),
                 "attn_bf16": (("attn_bf16_fwd_kernel", 12),),
                 "gcn_bf16": (("gcn_bf16_fwd_kernel", 16),),
                 "gcn": (("gcn_fwd_tc_kernel", 2),),
                 "gcn_bwd": (("gcn_bwd_row_tc_kernel", 2), ("gcn_bwd_col_tc_kernel", 2))}


def build_report():
    """Registers and spills of every kernel of the seven tensor-core
    libraries (GCN forward and backward, attention forward and backward,
    the bfloat16 GCN and attention forwards, the bfloat16 attention
    backward), and the tensor-core
    instructions (HMMA/HGMMA) in their SASS. The GCN kernels, the bfloat16
    kernels and the float32 attention forward at D = 64 must not spill;
    the bfloat16 libraries, each of the six D = 64 instantiations of the
    float32 attention forward (three flag sets, with and without DROP), K5
    bf16's persistent conv kernel (D = 64, 128), each of K4 bf16's twelve
    instantiations and each of K2 bf16's sixteen must hold HGMMA (wgmma)."""
    from paddlexde_tpu_torch.ops import _build

    for name, regs, stores, loads, stack in ptxas_report(_build.build_log("spline")):
        print(f"  ptxas spline: {name}: {regs} registers, spill stores {stores} B, spill loads "
              f"{loads} B, stack {stack} B", flush=True)
        require(stores + loads == 0, f"spline: {name} spills")
    for lib in ("gcn", "gcn_bwd", "attn", "attn_bwd", "gcn_bf16", "attn_bf16", "attn_bwd_bf16"):
        log = _build.build_log(lib)
        for line in log.splitlines():
            if "warning" in line.lower():
                print(f"  nvcc {lib}: {line.strip()}", flush=True)
        no_spills = lib.startswith("gcn") or lib.endswith("bf16")
        for name, regs, stores, loads, stack in ptxas_report(log):
            print(f"  ptxas {lib}: {name}: {regs} registers, spill stores {stores} B, "
                  f"spill loads {loads} B, stack {stack} B", flush=True)
            require(not (no_spills or ATTN_FWD_D64 in name) or stores + loads == 0,
                    f"{lib}: {name} spills")
        sass = subprocess.run([_build.tool("cuobjdump"), "-sass", str(_build.library_path(lib))],
                              capture_output=True, text=True, timeout=600, check=True).stdout
        n_tc = sum(1 for line in sass.splitlines() if "HMMA" in line or "HGMMA" in line)
        n_hgmma = sum(1 for line in sass.splitlines() if "HGMMA" in line)
        drop_tc, drop_hgmma = dropout_tensor_core_counts(sass)
        print(f"  {lib}: {n_tc} tensor-core instructions (HMMA/HGMMA) in the SASS, "
              f"{n_hgmma} HGMMA; without the dropout instantiations {n_tc - drop_tc} and "
              f"{n_hgmma - drop_hgmma}", flush=True)
        require(n_tc > 0, f"the {lib} library has no tensor-core instruction")
        require(not lib.endswith("bf16") or n_hgmma > 0, f"the {lib} library has no HGMMA")
        if lib == "attn":
            d64 = hgmma_by_function(sass, ATTN_FWD_D64)
            drop = sorted(v for k, v in d64.items() if "Lb1EEEv" in k)
            no_drop = sorted(v for k, v in d64.items() if "Lb1EEEv" not in k)
            print(f"  {lib}: HGMMA of the D = 64 instantiations of attn_fwd_d3stn_kernel "
                  f"{no_drop}, of their dropout forms {drop}", flush=True)
            require(len(drop) == len(no_drop) == 3 and all(d64.values()),
                    f"{lib}: a D = 64 attention forward is missing or has no HGMMA: {d64}")
        if lib == "attn_bwd_bf16":
            dw = hgmma_by_function(sass, "attn_bwd_bf16_dw_kernel")
            print(f"  {lib}: HGMMA of the weight-gradient kernels {sorted(dw.values())}",
                  flush=True)
            require(len(dw) == 2 and all(dw.values()), f"{lib}: a dw kernel has no HGMMA: {dw}")
        for symbol, want in HGMMA_KERNELS.get(lib, ()):
            hg = hgmma_by_function(sass, symbol)
            regs = sorted(r for name, r, *_ in ptxas_report(log) if symbol in name)
            print(f"  {lib}: {symbol}: {len(hg)} instantiations, HGMMA {sorted(hg.values())}, "
                  f"registers {regs}, no spills", flush=True)
            require(len(hg) == want and len(regs) == want and all(hg.values()),
                    f"{lib}: {symbol} missing or without HGMMA: {hg}")


# --------------------------------------------------------------------------
# phase 1: every kernel against its plain version at the PEMS08 shapes
# --------------------------------------------------------------------------


def check_spline(torch, dev, gen):
    """K1 at PEMS08 (series [32, 170, 2016, 3]) on two query sets: an
    edge-case set (knots, both ends, out of range) through the one-set
    wrapper, and the main path's, ``init_lag_anchors``' decoder and encoder
    lags, through the pair kernel. The forward and the derivative basis must
    equal the plain version bit for bit, the pair in one launch; the lag
    gradient (float32 and float64) must give the same bits twice in one
    launch and be within SPLINE_BWD_TOL of the plain one per query, relative
    to the sum of |g dH/dq|; the lag backward of the pair alone must trace as
    one kernel. Times: device time of each kernel (profiler) beside its byte
    bound for each query set, the launch floor, the plain versions (CUDA
    events) and the host time per wrapper call."""
    from paddlexde_tpu_torch.models.d3stn import load_config
    from paddlexde_tpu_torch.models.d3stn.trainer import init_lag_anchors
    from paddlexde_tpu_torch.ops import _build, spline
    from paddlexde_tpu_torch.ops.timing import (
        bound_ms,
        device_ms,
        host_ms_per_call,
        launch_floor_ms,
        spline_work,
        time_ms,
    )

    cfg = load_config(str(HERE / "examples" / "configs" / "PEMS08.json"))
    b, n, t_len, d = 32, cfg.num_nodes, cfg.his_len, 3
    series = torch.randn(b, n, t_len, d, generator=gen, device=dev)
    t = torch.arange(t_len, dtype=torch.float32, device=dev)
    # on knots, fractional, in the last interval, at the last knot, out of range
    edge = torch.tensor([0.0, 1.0, 7.25, 1000.0, 1500.5, 2013.75, 2014.0, 2014.3,
                         2014.9, 2015.0, -3.5, 2100.0], device=dev)
    enc, dec = (torch.tensor(v, device=dev) for v in init_lag_anchors(cfg))
    plain = spline.gather_eval_plain

    def pair(derivative=False):
        before = _build.LAUNCHES["spline"]
        out = spline.gather_pair_kernel(series, t, dec, enc, derivative)
        require(_build.LAUNCHES["spline"] == before + 1, "the pair forward is not one launch")
        return out

    for derivative in (False, True):
        got = spline.gather_eval_kernel(series, t, edge, derivative)
        require(torch.equal(got, plain(series, t, edge, derivative)),
                f"spline kernel (edge set, derivative={derivative}): not the plain version's bits")
        out_a, out_b = pair(derivative)
        require(torch.isfinite(out_a).all().item() and torch.isfinite(out_b).all().item(),
                "spline pair kernel: non-finite output")
        require(torch.equal(out_a, plain(series, t, dec, derivative))
                and torch.equal(out_b, plain(series, t, enc, derivative)),
                f"spline pair kernel (derivative={derivative}): not the plain version's bits")
        again = pair(derivative)
        require(torch.equal(out_a, again[0]) and torch.equal(out_b, again[1]),
                "spline pair kernel: two runs on the same inputs differ")

    errs = {}
    for dtype in (torch.float32, torch.float64):
        x = series.to(dtype)
        g_dec, g_enc, g_edge = (torch.randn(b, n, q.numel(), d, generator=gen, device=dev,
                                            dtype=dtype) for q in (dec, enc, edge))
        runs = []
        for _ in range(2):
            before = _build.LAUNCHES["spline_bwd"]
            runs.append(spline.lag_grad_kernel(x, t, dec, g_dec, enc, g_enc))
            require(_build.LAUNCHES["spline_bwd"] == before + 1,
                    "the lag gradient is not one launch")
        require(all(torch.equal(u, v) for u, v in zip(*runs)),
                f"lag gradient ({dtype}): two runs on the same inputs differ")
        single = spline.lag_grad_kernel(x, t, edge, g_edge)[0]
        for q, g, gq in ((dec, g_dec, runs[0][0]), (enc, g_enc, runs[0][1]),
                         (edge, g_edge, single)):
            terms = g * plain(x, t, q, True)
            scale = terms.abs().sum(dim=(0, 1, 3))
            err = ((gq - terms.sum(dim=(0, 1, 3))).abs() / scale).max().item()
            errs[dtype] = max(errs.get(dtype, 0.0), err)
        tol = SPLINE_BWD_TOL[str(dtype)[6:]]
        require(errs[dtype] <= tol, f"lag gradient ({dtype}) vs its plain version: "
                f"{errs[dtype]:.3e} > {tol:g} of the sum of |g dH/dq|")
        print(f"  spline lag gradient ({str(dtype)[6:]}): {errs[dtype]:.3e} of the sum of "
              f"|g dH/dq| from the plain version (tol {tol:g}), the same bits twice, one launch",
              flush=True)

    # the lag backward of the pair alone: one kernel, no multiply or sum
    dec_q, enc_q = dec.clone().requires_grad_(), enc.clone().requires_grad_()
    outs = spline.hermite_gather_eval_pair(series, t, dec_q, enc_q)
    cot = [torch.randn(o.shape, generator=gen, device=dev) for o in outs]
    for _ in range(3):  # a trace can drop a launch record, never add one
        kernels = traced_kernels(torch, lambda: torch.autograd.grad(outs, (dec_q, enc_q), cot,
                                                                     retain_graph=True))
        if kernels:
            break
    print(f"  the pair's lag backward (autograd) traced as {kernels}", flush=True)
    require(len(kernels) == 1 and KERNEL_NAMES["spline_bwd"][0] in kernels[0],
            f"the lag backward ran {kernels}, expected one {KERNEL_NAMES['spline_bwd'][0]}")

    sym, bwd_sym = KERNEL_NAMES["spline"][0], KERNEL_NAMES["spline_bwd"][0]
    g_dec, g_enc = cot
    idx = {name: spline._prep(series, t, q)[0].tolist() for name, q in
           (("edge", edge), ("decoder", dec), ("encoder", enc))}
    bounds = {name: bound_ms(spline_work(b, n, t_len, d, i, len(i))) for name, i in idx.items()}
    both = idx["decoder"] + idx["encoder"]
    bounds["pair"] = bound_ms(spline_work(b, n, t_len, d, both, len(both)))
    bwd_bound = bound_ms(spline_work(b, n, t_len, d, both, len(both), derivative=True))
    edge_ms = device_ms(lambda: spline.gather_eval_kernel(series, t, edge), sym)
    one_ms = {name: device_ms(lambda q=q: spline.gather_eval_kernel(series, t, q), sym)
              for name, q in (("decoder", dec), ("encoder", enc))}
    pair_ms = device_ms(lambda: spline.gather_pair_kernel(series, t, dec, enc), sym)
    bwd_ms = device_ms(lambda: spline.lag_grad_kernel(series, t, dec, g_dec, enc, g_enc), bwd_sym)
    floor_ms = launch_floor_ms(dev)
    host = {"gather_pair_kernel": host_ms_per_call(
                lambda: spline.gather_pair_kernel(series, t, dec, enc)),
            "gather_eval_kernel": host_ms_per_call(
                lambda: spline.gather_eval_kernel(series, t, dec)),
            "lag_grad_kernel": host_ms_per_call(
                lambda: spline.lag_grad_kernel(series, t, dec, g_dec, enc, g_enc))}
    plain_ms = time_ms(lambda: (plain(series, t, dec), plain(series, t, enc)))
    bwd_plain_ms = time_ms(lambda: (spline.lag_grad_plain(series, t, dec, g_dec),
                                    spline.lag_grad_plain(series, t, enc, g_enc)))
    for name, ms in (("edge", edge_ms), *one_ms.items()):
        print(f"  spline kernel, {name} set alone: {ms:.4f} ms (device, profiler), bound "
              f"{bounds[name][0]:.6f} ms by {bounds[name][1]}", flush=True)
    print(f"  spline pair kernel, decoder + encoder sets: {pair_ms:.4f} ms (device, profiler), "
          f"bound {bounds['pair'][0]:.6f} ms by {bounds['pair'][1]}; lag gradient kernel, both "
          f"sets: {bwd_ms:.4f} ms, bound {bwd_bound[0]:.6f} ms by {bwd_bound[1]}; launch floor "
          f"{floor_ms:.4f} ms (one elementwise op on one element, same profiler path)",
          flush=True)
    print("  host time per wrapper call (perf_counter over 200 calls): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in host.items()), flush=True)
    shape = f"series [{b},{n},{t_len},{d}], decoder + encoder lags (12 + 12)"
    return {"spline": dict(err=0.0, ms=pair_ms, plain_ms=plain_ms, bound_main=bounds["pair"],
                           host_ms=host["gather_pair_kernel"], floor_ms=floor_ms,
                           shape=shape + "; bitwise the plain version, one launch"),
            "spline_bwd": dict(err=errs[torch.float32], ms=bwd_ms, plain_ms=bwd_plain_ms,
                               bound_main=bwd_bound, host_ms=host["lag_grad_kernel"],
                               floor_ms=floor_ms,
                               shape=shape + "; the same bits twice, one launch")}


def traced_kernels(torch, fn):
    """The CUDA kernel names of one call of ``fn`` (after a warm-up call),
    from a profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def check_gcn(torch, dev, gen):
    from paddlexde_tpu_torch.ops import gcn
    from paddlexde_tpu_torch.ops.timing import bound_3xtf32_ms, bound_ms, device_ms, gcn_work, time_ms

    b, n, t_len, d = 32, 170, 12, 128
    x = torch.randn(b, n, t_len, d, generator=gen, device=dev)
    gate = 0.5 * torch.rand(n, n, generator=gen, device=dev)
    scale2 = 1.0 / d ** 0.5
    got, again = (gcn.gcn_spatial_mix_kernel(x, gate, scale2) for _ in range(2))
    want = gcn.gcn_spatial_mix_plain(x, gate, scale2)
    torch.cuda.synchronize()
    require(torch.isfinite(got).all().item(), "gcn kernel: non-finite output")
    require(torch.equal(got, again), "gcn kernel: two runs on the same inputs differ")
    err = norm_err(got, want)
    # the float64 plain version shows the kernel is right on its own
    err64 = norm_err(got.double(), gcn.gcn_spatial_mix_plain(x.double(), gate.double(), scale2,
                                                             dtype_name="float64"))
    require(err64 <= GCN_FWD_TOL64, f"gcn kernel vs float64 plain: {err64:.3e} "
            f"(tol {GCN_FWD_TOL64:g})")
    ms = device_ms(lambda: gcn.gcn_spatial_mix_kernel(x, gate, scale2), KERNEL_NAMES["gcn_fwd"][0])
    wrapper_ms = time_ms(lambda: gcn.gcn_spatial_mix_kernel(x, gate, scale2))
    plain_ms = time_ms(lambda: gcn.gcn_spatial_mix_plain(x, gate, scale2))
    return dict(err=err, err64=err64, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                bound=bound_ms(gcn_work(b, n, t_len, d)),
                bound3=bound_3xtf32_ms(gcn_work(b, n, t_len, d)),
                shape=f"x [{b},{n},{t_len},{d}], gate [{n},{n}]; bitwise equal twice")


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


def check_bf16(torch, label, run, plain):
    """A bfloat16 kernel call against its plain version: finite, the same
    bits twice, within one bfloat16 ulp at the top binade on at most
    BF16_SHARE of elements. Returns (err, ulp, share)."""
    from paddlexde_tpu_torch.ops.compare import bf16_errors

    got, again = run(), run()
    torch.cuda.synchronize()
    require(got.dtype == torch.bfloat16, f"{label}: output {got.dtype}, expected bfloat16")
    require(torch.isfinite(got.float()).all().item(), f"{label}: non-finite output")
    require(torch.equal(got, again), f"{label}: two runs on the same inputs differ")
    err, ulp, share = bf16_errors(got, plain())
    print(f"  {label}: vs the plain bfloat16 version max_abs_err(normalised) {err:.3e} "
          f"(one bfloat16 ulp at the top binade {ulp:.3e}), {share:.4%} of elements differ "
          f"(at most {BF16_SHARE:.0%}); bitwise equal twice", flush=True)
    require(err <= ulp and share <= BF16_SHARE,
            f"{label}: kernel disagrees with its plain version ({err:.3e} > {ulp:.3e} or "
            f"{share:.4%} of elements)")
    return err, ulp, share


def check_gcn_bf16(torch, dev, gen):
    from paddlexde_tpu_torch.ops import gcn
    from paddlexde_tpu_torch.ops.timing import bound_bf16_ms, device_ms, gcn_work, time_ms

    b, n, t_len, d = 32, 170, 12, 128
    x32 = torch.randn(b, n, t_len, d, generator=gen, device=dev)
    gate = 0.5 * torch.rand(n, n, generator=gen, device=dev)
    scale2 = 1.0 / d ** 0.5
    # x in bfloat16 takes the bfloat16 scores; x in float32, last, is what
    # D3STN passes (its LayerNorm output) and the result kept
    for x in (x32.to(torch.bfloat16), x32):
        run = lambda: gcn.gcn_spatial_mix_bf16_kernel(x, gate, scale2)  # noqa: E731
        plain = lambda: gcn.gcn_spatial_mix_plain(x, gate, scale2, "bfloat16")  # noqa: E731
        err, ulp, share = check_bf16(torch, f"gcn bf16 kernel, x {x.dtype}", run, plain)
        work = gcn_work(b, n, t_len, d, x_bytes=x.element_size(), y_bytes=2)
        res = dict(err=err, ulp=ulp, share=share, ms=device_ms(run, "gcn_bf16_"),
                   wrapper_ms=time_ms(run), plain_ms=time_ms(plain), bound16=bound_bf16_ms(work))
        print(f"  gcn bf16 kernel, x {x.dtype}: kernel {res['ms']:.4f} ms (device), plain "
              f"{res['plain_ms']:.4f} ms, bfloat16 bound {res['bound16'][0]:.4f} ms by "
              f"{res['bound16'][1]}, {res['bound16'][0] / res['ms']:.1%} of it", flush=True)
    res["shape"] = f"x [{b},{n},{t_len},{d}] float32, gate [{n},{n}] -> y bfloat16"
    return res


def check_attn_bf16(torch, dev, gen):
    from paddlexde_tpu_torch.ops import attn
    from paddlexde_tpu_torch.ops.timing import (
        attn_work,
        bound_bf16_ms,
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
    errs, shares, ulps, times, wrapper_times, plain_times = [], [], [], [], [], []
    for flags in ((False, False, False), (True, True, True), (True, False, False)):
        args = (mq, mk, vs, *weights, *flags, heads)
        run = lambda: attn.fused_temporal_attention_bf16_kernel(*args)  # noqa: E731
        plain = lambda: attn.fused_temporal_attention_plain(*args, "bfloat16")  # noqa: E731
        err, ulp, share = check_bf16(torch, f"attention bf16 kernel, flags {flags}", run, plain)
        errs.append(err)
        ulps.append(ulp)
        shares.append(share)
        times.append(device_ms(run, "attn_bf16_"))
        print_by_kernel(device_ms_by_kernel(run, "attn_bf16_"), flags)
        wrapper_times.append(time_ms(run))
        plain_times.append(time_ms(plain))
    work = attn_work(b, n, t_len, d, heads, ks, in_bytes=4, out_bytes=2)
    i = max(range(3), key=lambda k: errs[k] / ulps[k])
    return dict(err=errs[i], ulp=ulps[i], share=max(shares), ms=statistics.mean(times),
                wrapper_ms=statistics.mean(wrapper_times), plain_ms=statistics.mean(plain_times),
                bound16=bound_bf16_ms(work),
                per_flags=list(zip(errs, times, plain_times)),
                shape=f"[{b},{n},{t_len},{d}] float32 -> bfloat16, H={heads}, K={ks}, "
                      "3 flag sets")


def attn_inputs(torch, dev, gen, b=32, n=170, t_len=12, d=128, ks=3):
    """mq, mk, vs and the four convs' weights at a D3STN shape (the model's
    xavier bound, small biases)."""
    acts = [torch.randn(b, n, t_len, d, generator=gen, device=dev) for _ in range(3)]
    bound = (6.0 / (2 * ks * d)) ** 0.5
    weights = []
    for _ in range(4):
        weights.append((2 * torch.rand(ks, d, d, generator=gen, device=dev) - 1) * bound)
        weights.append(0.1 * torch.randn(d, generator=gen, device=dev))
    return acts, weights


def attn_bwd_bf16_errors(torch, args, control=False):
    """The bfloat16 attention backward kernel on ``args`` (mq, mk, vs, the
    weights, g, the flags, heads) against the plain bfloat16 backward on the
    same inputs: the largest of ``attn.bwd_errors``. ``control`` holds the
    parent's route instead of the kernel: autograd through the plain
    bfloat16 forward, which rounds dx_attn to bfloat16 before the core."""
    from paddlexde_tpu_torch.ops import attn

    want = attn.fused_temporal_attention_bwd_plain(*args, "bfloat16")
    if control:
        leaves = [a.detach().requires_grad_() for a in args[:11]]
        y = attn.fused_temporal_attention_plain(*leaves, *args[12:], "bfloat16")
        got = torch.autograd.grad(y, leaves, args[11])
    else:
        got = attn.fused_temporal_attention_bwd_bf16_kernel(*args)
    return max(attn.bwd_errors(got, want))


def dw_stage_work(rows, t_len, d, ks, splits):
    """K5 bf16's weight-gradient stage (its dw and sum kernels): mq, mk, vs
    (float32), x_attn and the four output gradients (bfloat16) read once,
    the float32 partials of ``splits`` splits written and read once, the
    weight and bias gradients written; 4 K products of 2 D^2 flops per
    (row, t) pair, the bias sums and the split sums."""
    from paddlexde_tpu_torch.ops.timing import Work

    act = rows * t_len * d
    out = 4 * ks * d * d + 4 * d
    return Work((3 * 4 + 2 + 4 * 2) * act + 2 * 4 * splits * out + 4 * out,
                4 * ks * 2 * d * d * rows * t_len, 4 * rows * t_len * d + splits * out)


def dw_stage_ms(by_kernel):
    """Device ms of the weight-gradient stage in one K5 bf16 call."""
    return sum(ms for name, ms in by_kernel.items() if "_dw_kernel" in name or "_sum_kernel" in name)


def conv_stage_work(rows, t_len, d, ks):
    """K5 bf16's conv stage (its conv kernel's two launches, kernels 2 and
    4): mq, mk, vs (float32) and g (bfloat16) read, q, k, v (bfloat16) and
    dx_attn (float32) written; dq, dk, dv (bfloat16) read, dmq, dmk, dvs
    (float32) written; the seven bfloat16 banks read once; seven convs of
    2 K D^2 flops per (row, t), their chains' float32 sums (D / 16 per
    output) and the three bias adds."""
    from paddlexde_tpu_torch.ops.timing import Work

    act = rows * t_len * d
    return Work((3 * 4 + 2 + 3 * 2 + 4 + 3 * 2 + 3 * 4) * act + 2 * 7 * ks * d * d,
                7 * 2 * ks * d * d * rows * t_len, 7 * act * (d // 16) + 3 * act)


def conv_stage_ms(by_kernel):
    """Device ms of the conv stage (both conv launches) in one K5 bf16 call."""
    return sum(ms for name, ms in by_kernel.items() if "_conv_kernel" in name)


def check_attn_bwd_bf16(torch, dev, gen):
    from paddlexde_tpu_torch.ops import attn
    from paddlexde_tpu_torch.ops.timing import (
        attn_bwd_work,
        bound_bf16_ms,
        device_ms_by_kernel,
        time_ms,
    )

    b, n, t_len, d, heads, ks = 32, 170, 12, 128, 8, 3
    acts, weights = attn_inputs(torch, dev, gen)
    g = torch.randn(b, n, t_len, d, generator=gen, device=dev).to(torch.bfloat16)
    splits = attn.bf16_dw_splits(b * n, d, torch.cuda.get_device_properties(dev)
                                 .multi_processor_count)
    stage_bound = bound_bf16_ms(dw_stage_work(b * n, t_len, d, ks, splits))
    conv_bound = bound_bf16_ms(conv_stage_work(b * n, t_len, d, ks))
    errs, controls, times, wrapper_times, plain_times, stage_times = [], [], [], [], [], []
    conv_times = []
    for flags in ((False, False, False), (True, True, True), (True, False, False)):
        args = (*acts, *weights, g, *flags, heads)
        run = lambda: attn.fused_temporal_attention_bwd_bf16_kernel(*args)  # noqa: E731
        got, again = run(), run()
        torch.cuda.synchronize()
        require(all(torch.isfinite(a).all().item() for a in got),
                f"attn_bwd_bf16 kernel {flags}: non-finite output")
        require(same_bits(torch, got, again), f"attn_bwd_bf16 kernel {flags}: two runs differ")
        require(all(a.dtype == torch.float32 for a in got),
                f"attn_bwd_bf16 kernel {flags}: gradients not float32")
        errs.append(attn_bwd_bf16_errors(torch, args))
        controls.append(attn_bwd_bf16_errors(torch, args, control=True))
        print(f"  flags {flags}: K5 bf16 vs the plain bfloat16 backward {errs[-1]:.3e} (limit "
              f"{ATTN_BWD_BF16_TOL:g}); control, autograd through the plain forward (the "
              f"parent's route) {controls[-1]:.3e}", flush=True)
        require(errs[-1] <= ATTN_BWD_BF16_TOL,
                f"attn_bwd_bf16 kernel {flags}: {errs[-1]:.3e} > {ATTN_BWD_BF16_TOL:g}")
        by_kernel = device_ms_by_kernel(run, "attn_bwd_bf16_")
        times.append(sum(by_kernel.values()))
        stage_times.append(dw_stage_ms(by_kernel))
        conv_times.append(conv_stage_ms(by_kernel))
        print_by_kernel(by_kernel, flags)
        print(f"  flags {flags}: conv stage (the conv kernel's two launches) "
              f"{conv_times[-1]:.4f} ms, its bound {conv_bound[0]:.4f} ms by {conv_bound[1]} "
              f"(inputs read once, outputs written once; bfloat16 products), "
              f"{conv_bound[0] / conv_times[-1]:.1%} of it", flush=True)
        print(f"  flags {flags}: weight-gradient stage (dw + sum kernels) {stage_times[-1]:.4f} "
              f"ms, its bound {stage_bound[0]:.4f} ms by {stage_bound[1]} (inputs read once, "
              f"{splits} splits' partials written and read; bfloat16 products), "
              f"{stage_bound[0] / stage_times[-1]:.1%} of it", flush=True)
        wrapper_times.append(time_ms(run))
        plain_times.append(time_ms(
            lambda: attn.fused_temporal_attention_bwd_plain(*args, "bfloat16")))
    work = attn_bwd_work(b, n, t_len, d, heads, ks, in_bytes=4, g_bytes=2)
    return dict(err=max(errs), control=min(controls), ms=statistics.mean(times),
                wrapper_ms=statistics.mean(wrapper_times), plain_ms=statistics.mean(plain_times),
                bound16=bound_bf16_ms(work), per_flags=list(zip(errs, times, plain_times)),
                stage_ms=statistics.mean(stage_times), stage_bound=stage_bound, splits=splits,
                conv_ms=statistics.mean(conv_times), conv_bound=conv_bound,
                shape=f"[{b},{n},{t_len},{d}] float32, g bfloat16, H={heads}, K={ks}, 3 flag "
                      "sets, 11 gradients; bitwise equal twice")


def check_gcn_bwd_bf16(torch, dev, gen):
    """K3 on a bfloat16 cotangent: the float32 kernel on g.float(), bit for
    bit; its time with the cast."""
    from paddlexde_tpu_torch.ops import gcn
    from paddlexde_tpu_torch.ops.timing import (
        bound_bf16_ms,
        device_ms_by_kernel,
        gcn_bwd_work,
        time_ms,
    )

    b, n, t_len, d = 32, 170, 12, 128
    x = torch.randn(b, n, t_len, d, generator=gen, device=dev)
    gate = 0.5 * torch.rand(n, n, generator=gen, device=dev)
    g = torch.randn(b, n, t_len, d, generator=gen, device=dev).to(torch.bfloat16)
    scale2 = 1.0 / d ** 0.5
    run = lambda: gcn.gcn_spatial_mix_bwd_bf16_kernel(x, gate, g, scale2)  # noqa: E731
    got, again = run(), run()
    want = gcn.gcn_spatial_mix_bwd_kernel(x, gate, g.float(), scale2)
    torch.cuda.synchronize()
    require(same_bits(torch, got, again), "gcn_bwd_bf16: two runs differ")
    require(same_bits(torch, got, want), "gcn_bwd_bf16: K3 on a bfloat16 g differs from K3 on "
            "g.float()")
    plain = lambda: gcn.gcn_spatial_mix_bwd_plain(x, gate, g.float(), scale2)  # noqa: E731
    err = max(norm_err(a, w) for a, w in zip(got, plain()))
    by_kernel = device_ms_by_kernel(run, "")  # the cast and the three K3 kernels
    print_by_kernel(by_kernel)
    cast_ms = sum(ms for name, ms in by_kernel.items() if "gcn_bwd_" not in name)
    return dict(err=err, ms=sum(by_kernel.values()), cast_ms=cast_ms, wrapper_ms=time_ms(run),
                plain_ms=time_ms(plain), bound16=bound_bf16_ms(gcn_bwd_work(b, n, t_len, d, 2)),
                shape=f"x [{b},{n},{t_len},{d}] float32, g bfloat16 -> dx float32, dgate "
                      f"[{n},{n}]; bitwise equal to K3 on g.float() and twice")


def keep_mask(torch, dev, gen, shape, rate=DROPOUT):
    """A pre-scaled keep mask {0, 1/keep} of ``shape``, as the model draws it."""
    keep = 1.0 - rate
    return (torch.rand(shape, generator=gen, device=dev) < keep).float() / keep


def check_attn_dropout(torch, dev, gen, bf16):
    """The dropout forms of K4 and K5 (float32 or bfloat16) at the PEMS08
    shapes with a dropout-0.1 keep mask, against their plain versions on the
    same inputs and mask (float32: TOL; bfloat16: one ulp on at most
    BF16_SHARE of elements forward, ATTN_BWD_BF16_TOL backward), each run
    twice for the same bits, and an all-keep mask giving the no-dropout
    kernel's bits. Returns the forward's and the backward's results."""
    from paddlexde_tpu_torch.ops import attn
    from paddlexde_tpu_torch.ops.timing import (
        attn_bwd_work,
        attn_work,
        bound_3xtf32_ms,
        bound_bf16_ms,
        device_ms,
        time_ms,
    )

    b, n, t_len, d, heads, ks = 32, 170, 12, 128, 8, 3
    acts, weights = attn_inputs(torch, dev, gen)
    g = torch.randn(b, n, t_len, d, generator=gen, device=dev)
    mask = keep_mask(torch, dev, gen, (b, n, t_len, heads * t_len))
    ones = torch.ones_like(mask)
    dtype_name = "bfloat16" if bf16 else "float32"
    if bf16:
        g = g.to(torch.bfloat16)
        fwd, bwd = attn.fused_temporal_attention_bf16_kernel, attn.fused_temporal_attention_bwd_bf16_kernel
        bound, fsym, bsym = bound_bf16_ms, "attn_bf16_", "attn_bwd_bf16_"
    else:
        fwd, bwd = attn.fused_temporal_attention_kernel, attn.fused_temporal_attention_bwd_kernel
        bound, fsym, bsym = bound_3xtf32_ms, "attn_fwd_", "attn_bwd_"
    fres = {"err": [], "ms": [], "plain_ms": []}
    bres = {"err": [], "ms": [], "plain_ms": []}
    for flags in ((False, False, False), (True, True, True), (True, False, False)):
        args = (*acts, *weights, *flags, heads)
        run = lambda: fwd(*args, dropout_mask=mask)  # noqa: E731
        plain = lambda: attn.fused_temporal_attention_plain(*args, dtype_name, mask)  # noqa: E731
        if bf16:
            err = check_bf16(torch, f"attention bf16 dropout kernel, flags {flags}", run, plain)[0]
        else:
            got, again = run(), run()
            torch.cuda.synchronize()
            require(torch.isfinite(got).all().item(), f"attention dropout kernel {flags}: non-finite")
            require(torch.equal(got, again), f"attention dropout kernel {flags}: two runs differ")
            err = norm_err(got, plain())
            require(err <= TOL["attn_fwd"], f"attention dropout kernel {flags}: {err:.3e} from "
                    f"its plain version (tol {TOL['attn_fwd']:g})")
        require(torch.equal(fwd(*args, dropout_mask=ones), fwd(*args)),
                f"{dtype_name} attention dropout kernel {flags}: an all-keep mask does not give "
                "the no-dropout kernel's bits")
        fres["err"].append(err)
        fres["ms"].append(device_ms(run, fsym))
        fres["plain_ms"].append(time_ms(plain))

        bargs = (*acts, *weights, g, *flags, heads)
        brun = lambda: bwd(*bargs, dropout_mask=mask)  # noqa: E731
        bplain = lambda: attn.fused_temporal_attention_bwd_plain(*bargs, dtype_name, mask)  # noqa: E731
        got, again = brun(), brun()
        torch.cuda.synchronize()
        require(all(torch.isfinite(a).all().item() for a in got),
                f"{dtype_name} attention dropout backward {flags}: non-finite output")
        require(same_bits(torch, got, again),
                f"{dtype_name} attention dropout backward {flags}: two runs differ")
        require(same_bits(torch, bwd(*bargs, dropout_mask=ones), bwd(*bargs)),
                f"{dtype_name} attention dropout backward {flags}: an all-keep mask does not "
                "give the no-dropout kernels' bits")
        err = max(attn.bwd_errors(got, bplain()))
        tol = ATTN_BWD_BF16_TOL if bf16 else TOL["attn_bwd"]
        require(err <= tol, f"{dtype_name} attention dropout backward {flags}: {err:.3e} from "
                f"its plain version (tol {tol:g})")
        del got, again
        bres["err"].append(err)
        bres["ms"].append(device_ms(brun, bsym))
        bres["plain_ms"].append(time_ms(bplain))
        print(f"  {dtype_name} dropout, flags {flags}: K4 err {fres['err'][-1]:.3e} kernel "
              f"{fres['ms'][-1]:.4f} ms plain {fres['plain_ms'][-1]:.4f} ms; K5 err "
              f"{bres['err'][-1]:.3e} kernel {bres['ms'][-1]:.4f} ms plain "
              f"{bres['plain_ms'][-1]:.4f} ms; the same bits twice, all-keep = no-dropout bits",
              flush=True)
    in_b, out_b = (4, 2) if bf16 else (4, 4)
    fwork = attn_work(b, n, t_len, d, heads, ks, in_b, out_b, dropout=True)
    bwork = attn_bwd_work(b, n, t_len, d, heads, ks, 4, 2 if bf16 else 4, dropout=True)
    shape = (f"[{b},{n},{t_len},{d}], H={heads}, K={ks}, mask [{b},{n},{t_len},{heads * t_len}] "
             f"at dropout {DROPOUT}, 3 flag sets; bitwise equal twice")
    out = []
    for res, work in ((fres, fwork), (bres, bwork)):
        out.append(dict(err=max(res["err"]), ms=statistics.mean(res["ms"]),
                        plain_ms=statistics.mean(res["plain_ms"]), bound_main=bound(work),
                        shape=shape))
    return out


def check_attn_d64(torch, dev, gen):
    """K4 and K4 dropout at SYNTH's shapes (B 32, N 16, T 12, D 64, 4 heads,
    K 3; the tensor-core ``attn_fwd_d3stn_kernel<64, ...>``), each flag set:
    against the float32 and float64 plain versions within TOL["attn_fwd"],
    the same bits twice, an all-keep mask giving the no-dropout kernel's
    bits. Returns the two forms' results."""
    from paddlexde_tpu_torch.ops import attn
    from paddlexde_tpu_torch.ops.timing import (
        attn_work,
        bound_3xtf32_ms,
        device_ms_by_kernel,
        time_ms,
    )

    b, n, t_len, d, heads, ks = 32, 16, 12, 64, 4, 3
    acts, weights = attn_inputs(torch, dev, gen, b, n, t_len, d, ks)
    mask = keep_mask(torch, dev, gen, (b, n, t_len, heads * t_len))
    ones = torch.ones_like(mask)
    res = {m: {"err": [], "err64": [], "ms": [], "plain_ms": []} for m in ("", "_dropout")}
    for flags in ((False, False, False), (True, True, True), (True, False, False)):
        args = (*acts, *weights, *flags, heads)
        route = attn.f32_fwd_route(*acts[:2], weights[0], *flags, heads, dropout=True)
        require(route == "d3stn", f"K4 at SYNTH's shape {flags} routes to {route}")
        for form, m in (("", None), ("_dropout", mask)):
            run = lambda: attn.fused_temporal_attention_kernel(*args, m)  # noqa: E731
            plain = lambda: attn.fused_temporal_attention_plain(*args, "float32", m)  # noqa: E731
            got, again = run(), run()
            torch.cuda.synchronize()
            label = f"attention{form.replace('_', ' ')} kernel at D = 64, flags {flags}"
            require(torch.isfinite(got).all().item(), f"{label}: non-finite output")
            require(torch.equal(got, again), f"{label}: two runs on the same inputs differ")
            err = norm_err(got, plain())
            want64 = attn.fused_temporal_attention_plain(
                *[a.double() for a in args[:11]], *flags, heads, "float64",
                None if m is None else m.double())
            err64 = norm_err(got.double(), want64)
            require(max(err, err64) <= TOL["attn_fwd"], f"{label}: {err:.3e} from the float32 "
                    f"and {err64:.3e} from the float64 plain version (tol {TOL['attn_fwd']:g})")
            by_kernel = device_ms_by_kernel(run, "attn_fwd_")
            require(all("attn_fwd_d3stn_kernel<64" in name or "attn_fwd_wsplit_kernel<64" in name
                        for name in by_kernel) and len(by_kernel) == 2,
                    f"{label}: the profiler shows {sorted(by_kernel)}")
            r = res[form]
            r["err"].append(err)
            r["err64"].append(err64)
            r["ms"].append(sum(by_kernel.values()))
            r["plain_ms"].append(time_ms(plain))
            print_by_kernel(by_kernel, flags)
        require(torch.equal(attn.fused_temporal_attention_kernel(*args, ones),
                            attn.fused_temporal_attention_kernel(*args)),
                f"attention dropout kernel at D = 64, flags {flags}: an all-keep mask does not "
                "give the no-dropout kernel's bits")
        print(f"  D = 64, flags {flags}: K4 err {res['']['err'][-1]:.3e} (float64 "
              f"{res['']['err64'][-1]:.3e}) kernel {res['']['ms'][-1]:.4f} ms plain "
              f"{res['']['plain_ms'][-1]:.4f} ms; K4 dropout err {res['_dropout']['err'][-1]:.3e} "
              f"(float64 {res['_dropout']['err64'][-1]:.3e}) kernel "
              f"{res['_dropout']['ms'][-1]:.4f} ms plain {res['_dropout']['plain_ms'][-1]:.4f} "
              "ms; the same bits twice, all-keep = no-dropout bits", flush=True)
    out = {}
    for form, r in res.items():
        work = attn_work(b, n, t_len, d, heads, ks, dropout=bool(form))
        out[f"attn_fwd{form}_d64"] = dict(
            err=max(r["err"]), err64=max(r["err64"]), ms=statistics.mean(r["ms"]),
            plain_ms=statistics.mean(r["plain_ms"]), bound_main=bound_3xtf32_ms(work),
            per_flags=list(zip(r["err"], r["ms"], r["plain_ms"])),
            shape=f"[{b},{n},{t_len},{d}], H={heads}, K={ks}, 3 flag sets"
                  + (f", mask at dropout {DROPOUT}" if form else "") + "; bitwise equal twice")
    return out


def kernel_phase(torch, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    results = check_spline(torch, dev, gen)
    for name, res in results.items():
        print(f"kernel {name} ({res['shape']}): max_abs_err={res['err']:.3e} kernel "
              f"{res['ms']:.4f} ms (device, profiler; launch floor {res['floor_ms']:.4f} ms), "
              f"host {res['host_ms']:.4f} ms a wrapper call, plain {res['plain_ms']:.4f} ms (CUDA "
              f"events), bound {res['bound_main'][0]:.6f} ms by {res['bound_main'][1]}, "
              f"launches per Predictor batch {LAUNCHES_PER_BATCH[name]}, per train step "
              f"{LAUNCHES_PER_STEP[name]}", flush=True)
    for name, fn in (("gcn_fwd", check_gcn), ("gcn_bwd", check_gcn_bwd),
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
        res["bound_main"] = res["bound3"]
        results[name] = res
    for name, fn in (("gcn_fwd_bf16", check_gcn_bf16), ("attn_fwd_bf16", check_attn_bf16)):
        res = fn(torch, dev, gen)
        f32 = results[name[: -len("_bf16")]]
        print(f"kernel {name} ({res['shape']}): max_abs_err(normalised)={res['err']:.3e} "
              f"(one bfloat16 ulp {res['ulp']:.3e}), {res['share']:.4%} of elements differ; "
              f"kernel {res['ms']:.4f} ms (device, profiler; the float32 kernel "
              f"{f32['ms']:.4f} ms), wrapper {res['wrapper_ms']:.4f} ms, plain "
              f"{res['plain_ms']:.4f} ms (CUDA events), bound {res['bound16'][0]:.4f} ms by "
              f"{res['bound16'][1]} (bfloat16 products), launches per bfloat16 Predictor batch "
              f"{LAUNCHES_PER_BATCH_BF16[name]}", flush=True)
        for flags_res in res.get("per_flags", ()):
            print(f"  flag set: err {flags_res[0]:.3e}, kernel {flags_res[1]:.4f} ms (device), "
                  f"plain {flags_res[2]:.4f} ms", flush=True)
        res["bound_main"] = res["bound16"]
        results[name] = res
    for name, fn in (("gcn_bwd_bf16", check_gcn_bwd_bf16), ("attn_bwd_bf16", check_attn_bwd_bf16)):
        res = fn(torch, dev, gen)
        f32 = results[name[: -len("_bf16")]]
        print(f"kernel {name} ({res['shape']}): max_abs_err(normalised)={res['err']:.3e} "
              f"against the plain bfloat16 backward; kernel {res['ms']:.4f} ms (device, "
              f"profiler; the float32 kernel {f32['ms']:.4f} ms), wrapper "
              f"{res['wrapper_ms']:.4f} ms, plain {res['plain_ms']:.4f} ms (CUDA events), bound "
              f"{res['bound16'][0]:.4f} ms by {res['bound16'][1]} (bfloat16 products; K3's stay "
              f"float32, 3xTF32), launches per bfloat16 train step "
              f"{LAUNCHES_PER_STEP_BF16[name]}", flush=True)
        if "cast_ms" in res:
            print(f"  of which the cast of g to float32 {res['cast_ms']:.4f} ms", flush=True)
        if "stage_ms" in res:
            print(f"  of which the weight-gradient stage {res['stage_ms']:.4f} ms against its "
                  f"bound {res['stage_bound'][0]:.4f} ms by {res['stage_bound'][1]} "
                  f"({res['splits']} splits), {res['stage_bound'][0] / res['stage_ms']:.1%} of "
                  "it", flush=True)
        if "conv_ms" in res:
            print(f"  of which the conv stage {res['conv_ms']:.4f} ms against its bound "
                  f"{res['conv_bound'][0]:.4f} ms by {res['conv_bound'][1]}, "
                  f"{res['conv_bound'][0] / res['conv_ms']:.1%} of it", flush=True)
        for flags_res in res.get("per_flags", ()):
            print(f"  flag set: err {flags_res[0]:.3e}, kernel {flags_res[1]:.4f} ms (device), "
                  f"plain {flags_res[2]:.4f} ms", flush=True)
        res["bound_main"] = res["bound16"]
        results[name] = res
    for bf16 in (False, True):
        suffix = "_bf16" if bf16 else ""
        fres, bres = check_attn_dropout(torch, dev, gen, bf16)
        for name, res in ((f"attn_fwd{suffix}_dropout", fres), (f"attn_bwd{suffix}_dropout", bres)):
            base = results[name[: -len("_dropout")]]
            print(f"kernel {name} ({res['shape']}): max_abs_err(normalised)={res['err']:.3e} "
                  f"against its plain version; kernel {res['ms']:.4f} ms (device, profiler; the "
                  f"no-dropout kernel {base['ms']:.4f} ms), plain {res['plain_ms']:.4f} ms (CUDA "
                  f"events), bound {res['bound_main'][0]:.4f} ms by {res['bound_main'][1]} "
                  f"({'bfloat16' if bf16 else '3xTF32'} products, the mask read), launches per "
                  f"dropout train step {LAUNCHES_PER_STEP_DROPOUT_BF16[name] if bf16 else LAUNCHES_PER_STEP_DROPOUT[name]}",
                  flush=True)
            results[name] = res
    for name, res in check_attn_d64(torch, dev, gen).items():
        base = name[: -len("_d64")]
        per_step = (LAUNCHES_PER_STEP_DROPOUT if "dropout" in name else LAUNCHES_PER_STEP)[base]
        print(f"kernel {name} ({res['shape']}): max_abs_err(normalised)={res['err']:.3e} against "
              f"its float32 plain version, {res['err64']:.3e} against float64 (tol "
              f"{TOL['attn_fwd']:g}); kernel {res['ms']:.4f} ms (device, profiler; at PEMS08 "
              f"{results[base]['ms']:.4f} ms), plain {res['plain_ms']:.4f} ms (CUDA events), "
              f"bound {res['bound_main'][0]:.4f} ms by {res['bound_main'][1]} (3xTF32 "
              f"products), launches per SYNTH train step {per_step}", flush=True)
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


def bf16_distances(np, out, ref, f32):
    """The bfloat16 forecast on the kernels (``out``) against the one on the
    plain versions (``ref``), and the plain one against the float32
    forecast (``f32``) of the same weights: (max, mean) of each absolute
    difference over max |f32|."""
    scale = np.abs(f32).max()
    k, q = np.abs(out - ref) / scale, np.abs(ref - f32) / scale
    return (k.max(), k.mean()), (q.max(), q.mean())


def within_bf16_spread(k, q):
    """The rule for two bfloat16 forecasts of one model: their distance ``k``
    (max, mean) at most the plain bfloat16 forecast's distance ``q`` from the
    float32 one on the max, and at most half of it on the mean."""
    return k[0] <= q[0] and k[1] <= 0.5 * q[1]


def parent_conv_bf16(torch, orig):
    """``temporal_conv_plain`` with the rounding points the port had before
    it followed the TPU kernel: each tap rounded to bfloat16 and the taps
    summed in bfloat16 (the JAX ``_tconv_ref``)."""
    import torch.nn.functional as F

    from paddlexde_tpu_torch.ops import attn

    def conv(x, w, b, causal, dt=torch.float32):
        if dt != torch.bfloat16:
            return orig(x, w, b, causal, dt)
        k, t = w.shape[0], x.shape[-2]
        pad = attn._pad_cfg(k, causal)
        xp, w = F.pad(x.to(dt), (0, 0, pad[0], pad[1])), w.to(dt)
        return sum(torch.einsum("...td,df->...tf", xp[..., j : j + t, :], w[j])
                   for j in range(k)) + b.to(dt)

    return conv


def bf16_scores_of_bf16_x(torch, orig):
    """``gcn_spatial_mix_plain`` that rounds a float32 x to bfloat16 before
    its scores (the TPU kernel keeps them float32)."""

    def mix(x, gate, scale2=1.0, dtype_name="float32"):
        if dtype_name == "bfloat16":
            x = x.to(torch.bfloat16)
        return orig(x, gate, scale2, dtype_name)

    return mix


# the D3STN sublayers that run a bfloat16 kernel: attention and GCN blocks
BF16_SUBLAYERS = ("self_attn", "src_attn", "gcn")


def capture_sublayers(model, fn):
    """``(name, args, kwargs, output)`` of every call of an attention or GCN
    sublayer of ``model`` during ``fn()``."""
    calls, handles = [], []
    for name, module in model.named_modules():
        if name.rsplit(".", 1)[-1] in BF16_SUBLAYERS:
            handles.append(module.register_forward_hook(
                lambda m, args, kwargs, out, name=name: calls.append((name, args, kwargs, out)),
                with_kwargs=True))
    try:
        fn()
    finally:
        for h in handles:
            h.remove()
    return calls


def sublayer_errors(torch, plain_model, calls):
    """Each captured sublayer call run again in ``plain_model`` on the same
    inputs, against the captured output by the bfloat16 measure: (the
    largest error in top-binade ulps, the largest share of elements that
    differ, and whether both hold: at most one ulp, at most BF16_SHARE)."""
    from paddlexde_tpu_torch.ops.compare import bf16_errors

    ratio, share = 0.0, 0.0
    with torch.no_grad():
        for name, args, kwargs, out in calls:
            err, ulp, sh = bf16_errors(out, plain_model.get_submodule(name)(*args, **kwargs))
            ratio, share = max(ratio, err / ulp), max(share, sh)
    return ratio, share, ratio <= 1 and share <= BF16_SHARE


def bf16_witness_and_controls(torch, np, plain, cpu, batch, plain_out, f32_out, calls):
    """Readings that show what the bfloat16 checks tell apart, on one batch
    of 32:

    - the witness: the plain versions on the CPU (the same rounding points,
      other float32 sum orders) against the plain versions on the card;
    - two controls, each put in place of a plain version on the card: the
      attention conv at the parent's rounding points and the GCN taking its
      scores from bfloat16 x. The sublayer check must reject both; the
      forecast rule's verdict is printed."""
    from paddlexde_tpu_torch.ops import attn, gcn

    _, q = bf16_distances(np, plain_out, plain_out, f32_out)
    w, _ = bf16_distances(np, cpu(batch), plain_out, f32_out)
    print(f"  witness: plain bfloat16 on the CPU vs on the card, over max |float32 forecast|: "
          f"max {w[0]:.3e} mean {w[1]:.3e} (plain bfloat16 vs float32 max {q[0]:.3e} mean "
          f"{q[1]:.3e}); the forecast rule "
          f"{'holds' if within_bf16_spread(w, q) else 'fails'}", flush=True)
    controls = (("control 1, attention taps summed in bfloat16", attn, "temporal_conv_plain",
                 parent_conv_bf16),
                ("control 2, GCN scores of bfloat16 x", gcn, "gcn_spatial_mix_plain",
                 bf16_scores_of_bf16_x))
    for label, module, name, make in controls:
        orig = getattr(module, name)
        setattr(module, name, make(torch, orig))
        try:
            c, _ = bf16_distances(np, plain(batch), plain_out, f32_out)
            ratio, share, ok = sublayer_errors(torch, plain.model, calls)
        finally:
            setattr(module, name, orig)
        print(f"  {label}: forecast vs the plain versions' max {c[0]:.3e} mean {c[1]:.3e}, the "
              f"forecast rule {'holds' if within_bf16_spread(c, q) else 'rejects it'}; "
              f"sublayers vs the kernels' up to {ratio:.2f} ulp on up to {share:.4%} of "
              f"elements, the sublayer check {'holds' if ok else 'rejects it'}", flush=True)
        require(not ok, f"the bfloat16 sublayer check does not reject {label}")


def with_plain_history(cls):
    """``cls`` (Predictor or Trainer) with the spline class in place of the
    spline kernel: with ``*_impl="xla"`` the plain reference path."""
    from paddlexde_tpu_torch import history_index_pair

    class Plain(cls):
        def _history(self, lags_a, lags_b, src):
            return history_index_pair(lags_a, lags_b, src, self.his_span, interpolation="cubic",
                                      use_kernel=False)

    return Plain


def predictor_phase(torch, dev, dtype="float32", f32_outs=None, config="PEMS08"):
    """Serve ``config``-width requests with ``compute_dtype=dtype`` through the
    kernels and through the plain versions; returns the main path's
    launches, the forward's device time per batch of 32 and the outputs.

    In float32 the kernels' forecasts must lie within PREDICTOR_TOL of the
    plain versions'. In bfloat16 a float32 sum that the kernels take in
    another order can cross a bfloat16 rounding boundary, and the next
    roundings carry the ulp on through the layers, so the two forecasts are
    held against the float32 forecasts ``f32_outs`` of the same weights
    (:func:`within_bf16_spread`); each attention and GCN sublayer of one
    batch must agree with its plain version on the same inputs by the
    bfloat16 measure (:func:`sublayer_errors`), a check that two controls
    must fail (:func:`bf16_witness_and_controls`)."""
    import dataclasses

    import numpy as np

    from paddlexde_tpu_torch.models.d3stn import Predictor, load_config
    from paddlexde_tpu_torch.ops import _build
    from paddlexde_tpu_torch.ops.timing import time_ms

    PlainPredictor = with_plain_history(Predictor)

    bf16 = dtype == "bfloat16"
    per_batch = LAUNCHES_PER_BATCH_BF16 if bf16 else LAUNCHES_PER_BATCH
    cfg = load_config(str(HERE / "examples" / "configs" / f"{config}.json"), compute_dtype=dtype)
    plain_cfg = dataclasses.replace(cfg, attn_impl="xla", gcn_impl="xla")
    n, his = cfg.num_nodes, cfg.his_len
    rng = np.random.default_rng(0)
    a = rng.random((n, n))
    sc = ((a + a.T) / 2).astype(np.float32)
    adj = (rng.random((n, n)) < 0.03).astype(np.float32)
    adj = np.maximum(adj, adj.T)
    enc = (np.arange(12) + rng.random(12)).astype(np.float32)
    dec = (his - 1 - 1.5 * rng.random(cfg.tgt_len)).astype(np.float32)

    pred = Predictor(cfg, None, enc, dec, adj, sc, batch_size=32, device=dev,
                     generator=torch.Generator().manual_seed(0))
    plain = PlainPredictor(plain_cfg, None, enc, dec, adj, sc, batch_size=32, device=dev,
                      generator=torch.Generator().manual_seed(0))
    plain.model.load_state_dict(pred.model.state_dict())
    n_params = sum(p.numel() for p in pred.model.parameters())
    print(f"Predictor ({dtype}): {config} config (N={n}, his_len={his}, d_model={cfg.d_model}, "
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
    print(f"main path ({config}, {dtype}): {n_batches} Predictor batches, launches {launches}",
          flush=True)
    for name, count in per_batch.items():
        require(launches[name] == count * n_batches,
                f"{name}: {launches[name]} launches on the {dtype} main path, expected "
                f"{count} x {n_batches} batches")

    shapes = [(32, n, cfg.tgt_len), (32, n, cfg.tgt_len), (7, n, cfg.tgt_len),
              (len(starts), n, cfg.tgt_len)]
    for i, (out, ref, shape) in enumerate(zip(outs, plain_outs, shapes)):
        require(out.shape == shape, f"Predictor output {out.shape}, expected {shape}")
        require(np.isfinite(out).all(), "Predictor output is not finite")
        require(out.dtype == np.float32, f"Predictor output {out.dtype}, expected float32")
        if not bf16:
            err = np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)
            print(f"  request {shape}: kernels vs plain versions on the card, "
                  f"normalised max-abs err {err:.3e} (tol {PREDICTOR_TOL:g})", flush=True)
            require(err <= PREDICTOR_TOL,
                    f"Predictor {shape} disagrees with the plain path: {err:.3e}")
            continue
        (k_max, k_mean), (q_max, q_mean) = bf16_distances(np, out, ref, f32_outs[i])
        (f_max, f_mean), _ = bf16_distances(np, out, f32_outs[i], f32_outs[i])
        print(f"  request {shape}, bfloat16, over max |float32 forecast|: kernels vs plain "
              f"versions on the card max {k_max:.3e} mean {k_mean:.3e}; plain bfloat16 vs "
              f"float32 max {q_max:.3e} mean {q_mean:.3e}; kernels' bfloat16 vs float32 max "
              f"{f_max:.3e} mean {f_mean:.3e}", flush=True)
        require(within_bf16_spread((k_max, k_mean), (q_max, q_mean)),
                f"bfloat16 Predictor {shape}: the kernels' forecast is {k_max:.3e} (mean "
                f"{k_mean:.3e}) from the plain version's, which is {q_max:.3e} (mean "
                f"{q_mean:.3e}) from the float32 forecast")
    require(np.array_equal(outs[3][:64], np.concatenate([outs[0], outs[1]])),
            "predict_series differs from the host-window path")
    ragged_err = np.abs(outs[2] - outs[1][25:32]).max() / np.abs(outs[1]).max()
    print(f"  the ragged batch of 7 vs the same rows of the full batch: {ragged_err:.3e}",
          flush=True)
    require(ragged_err <= 1e-6, f"the ragged batch differs from the full batch ({ragged_err:.3e})")
    src = torch.as_tensor(windows[:32]).to(dev)
    if bf16:
        # teacher-forced: each attention and GCN sublayer of one batch on the
        # kernels against the plain sublayer on the same inputs
        calls = capture_sublayers(pred.model, lambda: pred.forward(src))
        ratio, share, ok = sublayer_errors(torch, plain.model, calls)
        print(f"  {len(calls)} attention and GCN sublayer calls, kernels vs plain versions on "
              f"the same inputs: up to {ratio:.2f} bfloat16 ulp at the top binade on up to "
              f"{share:.4%} of elements (at most 1 ulp, {BF16_SHARE:.0%})", flush=True)
        require(ok, "a bfloat16 sublayer disagrees with its plain version")
        cpu = PlainPredictor(plain_cfg, None, enc, dec, adj, sc, batch_size=32, device="cpu")
        cpu.model.load_state_dict(pred.model.state_dict())
        bf16_witness_and_controls(torch, np, plain, cpu, windows[:32], plain_outs[0],
                                  f32_outs[0], calls)
        del calls
    for label, s in (("kernels", secs), ("plain", plain_secs)):
        print(f"  {label}: request seconds (host clock, host array in, numpy out): "
              f"batch32 {s[0]:.4f}, batch32 {s[1]:.4f}, batch7 {s[2]:.4f}, "
              f"predict_series({len(starts)}) {s[3]:.4f} -> "
              f"{32 / s[1]:.1f} samples/s at batch 32, "
              f"{len(starts) / s[3]:.1f} samples/s resident", flush=True)

    # steady-state device latency of one resident batch of 32
    fwd_ms = time_ms(lambda: pred.forward(src), reps=10)
    plain_fwd_ms = time_ms(lambda: plain.forward(src), reps=10)
    print(f"  Predictor.forward ({dtype}), resident batch of 32 (CUDA events, median of 10): "
          f"kernels {fwd_ms:.3f} ms ({32e3 / fwd_ms:.1f} samples/s), "
          f"plain {plain_fwd_ms:.3f} ms ({32e3 / plain_fwd_ms:.1f} samples/s)", flush=True)

    device_us, by_name = traced_launches(torch, lambda: pred.forward(src), per_batch,
                                         f"one {config} {dtype} batch of 32",
                                         d64=cfg.d_model == 64)
    print(f"  Predictor.forward ({dtype}): device time per batch of 32 {device_us / 1e3:.3f} ms "
          f"({32e6 / device_us:.1f} samples/s on the card's clock; idle share "
          f"{1 - device_us / 1e3 / fwd_ms:.1%} of the event-timed forward)", flush=True)
    if bf16:
        from paddlexde_tpu_torch.ops.timing import attn_work, bound_bf16_ms, gcn_work

        b, t_len, d = 32, cfg.tgt_len, cfg.d_model
        bounds = {"gcn_fwd_bf16": bound_bf16_ms(gcn_work(b, n, t_len, d, 4, 2)),
                  "attn_fwd_bf16": bound_bf16_ms(attn_work(b, n, t_len, d, cfg.head,
                                                           cfg.kernel_size, 4, 2))}
        for key in BF16_KERNELS:
            ms = sum(us for name, us in by_name.items()
                     if any(sym in name for sym in KERNEL_NAMES[key])) / 1e3
            print(f"  {key} in the traced batch: {ms:.4f} ms in {per_batch[key]} calls, "
                  f"{ms / per_batch[key]:.4f} ms a call against its bfloat16 bound "
                  f"{bounds[key][0]:.4f} ms ({bounds[key][1]})", flush=True)
    return launches, device_us / 1e3, outs


def trace(torch, fn):
    """Launches per kernel key and symbol, total device time (us) and device
    time per kernel name, from a profiler trace of one call of ``fn``. A
    warm-up step runs ``fn`` once before the recorded one: a trace that
    starts on the first launch can drop that launch's record."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    counts = {k: [0] * len(symbols) for k, symbols in KERNEL_NAMES.items()}
    counts.update({k: [0] for k in ROUTE_NAMES})
    device_us, by_name = 0.0, {}
    for evt in prof.events():
        # the schedule's step annotation spans the step on the device
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.name.startswith(
                "ProfilerStep"):
            continue
        device_us += evt.device_time
        by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.device_time
        for key, symbols in KERNEL_NAMES.items():
            for i, symbol in enumerate(symbols):
                if symbol in evt.name:
                    counts[key][i] += 1
        for key, symbol in ROUTE_NAMES.items():
            counts[key][0] += symbol in evt.name
    return counts, device_us, by_name


def traced_launches(torch, fn, expected, label, d64=False):
    """Every kernel symbol launched exactly ``expected[key]`` times (times
    its ``LAUNCHES_PER_CALL``) in a profiler trace of ``fn``, the generic
    attention forward never, and the float32 attention forward at D = 64
    (``ROUTE_NAMES``) as often as the attention forward if ``d64``, else
    never. A trace can drop a launch record (seen once in a 10-launch
    trace), never add one: up to 3 traces, the first with every count exact
    passes. Returns the device time (us)
    and the time by kernel name of that trace."""
    from paddlexde_tpu_torch.ops.timing import LAUNCHES_PER_CALL

    by_symbols = {k: 0 for k in (*KERNEL_NAMES, *ROUTE_NAMES)}
    for key, per_call in expected.items():
        by_symbols[TRACED_AS.get(key, key)] += per_call
    if d64:
        by_symbols["attn_fwd_d64"] = by_symbols["attn_fwd"]
    # per symbol of each key
    expected = {key: [per_call * LAUNCHES_PER_CALL.get(sym, 1)
                      for sym in KERNEL_NAMES.get(key, (key,))]
                for key, per_call in by_symbols.items()}
    for attempt in range(3):
        counts, device_us, by_name = trace(torch, fn)
        print(f"  profiler, {label} (trace {attempt + 1}): kernel launches {counts}, "
              f"device time {device_us / 1e3:.3f} ms in {len(by_name)} kernel names", flush=True)
        for key, want in expected.items():
            require(all(c <= w for c, w in zip(counts[key], want)),
                    f"profiler shows {counts[key]} {key} launches in {label}, expected {want}")
        exact = all(counts[key] == want for key, want in expected.items())
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


def train_inputs(np, n):
    """The train phases' graph (seeded) and synthetic series of 14 days."""
    from paddlexde_tpu_torch.models.d3stn import synthetic_traffic_npz

    rng = np.random.default_rng(0)
    a = rng.random((n, n))
    sc = ((a + a.T) / 2).astype(np.float32)
    adj = (rng.random((n, n)) < 0.03).astype(np.float32)
    adj = np.maximum(adj, adj.T)
    return adj, sc, synthetic_traffic_npz(num_nodes=n, seq_len=288 * 14)


def train_phase(torch, dev, config="PEMS08", epochs=True):
    """The float32 train step of ``config`` at batch 32: one step on the
    kernels against one on the plain versions (loss and every gradient
    within TRAIN_TOL), the launches of a step by counter and profiler, the
    step time; then, with ``epochs``, a 1+1-epoch ``Trainer.train()`` whose
    best checkpoint a Predictor serves, else TRAIN_STEPS more steps with a
    finite loss. Returns the launches of the epochs or of those steps and
    the traced step's device time (ms)."""
    import dataclasses
    import shutil

    import numpy as np

    from paddlexde_tpu_torch.models.d3stn import Predictor, Trainer, load_config
    from paddlexde_tpu_torch.ops import _build
    from paddlexde_tpu_torch.ops.timing import time_ms

    PlainTrainer = with_plain_history(Trainer)

    save_dir = HERE / "experiments" / f"chip_smoke_{config}"
    shutil.rmtree(save_dir, ignore_errors=True)
    cfg = load_config(str(HERE / "examples" / "configs" / f"{config}.json"), batch_size=32,
                      train_epochs=1, finetune_epochs=1, save_dir=str(save_dir))
    plain_cfg = dataclasses.replace(cfg, attn_impl="xla", gcn_impl="xla",
                                    save_dir=str(save_dir / "plain"))
    n = cfg.num_nodes
    adj, sc, data = train_inputs(np, n)
    t0 = time.perf_counter()
    tr = Trainer(cfg, data=data, adj_matrix=adj, sc_matrix=sc, device=dev)
    plain = PlainTrainer(plain_cfg, data=data, adj_matrix=adj, sc_matrix=sc, device=dev)
    plain.model.load_state_dict(tr.model.state_dict())
    n_params = sum(p.numel() for p in tr.model.parameters())
    print(f"Trainer: {config} config at batch 32 ({cfg.encoder_num_layers}+"
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
                                         LAUNCHES_PER_STEP, f"one {config} train step at batch 32",
                                         d64=cfg.d_model == 64)

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
    if not epochs:
        # 4. a few more steps on other windows
        batches = list(tr.train_dataset.batch_starts(cfg.batch_size, shuffle=True, seed=1,
                                                     drop_last=True))[:TRAIN_STEPS]
        _build.reset_launches()
        losses = torch.stack([tr.train_step_idx(s_b, kl, *lr)[0] for s_b in batches]).cpu().numpy()
        launches = dict(_build.LAUNCHES)
        print(f"  {len(batches)} more {config} train steps: losses {losses.tolist()}; launches "
              f"{launches}", flush=True)
        require(np.isfinite(losses).all(), f"a {config} train step gave a non-finite loss")
        require(launches == {k: len(batches) * v for k, v in LAUNCHES_PER_STEP.items()},
                f"{len(batches)} {config} train steps launched {launches}")
        shutil.rmtree(save_dir, ignore_errors=True)
        return launches, device_us / 1e3

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
    return launches, device_us / 1e3


def check_bf16_step(torch, np, label, names, kernels, plain, f32, pooled=False, witness=None):
    """A bfloat16 step on the kernels against the same step on the plain
    bfloat16 versions, both against the float32 step (each ``(loss,
    gradients)``): the loss no further from the plain step than the plain
    step is from float32; each gradient within the plain step's distance
    from float32 (:func:`within_bf16_spread`), a gradient that the model's
    backward rounds to bfloat16 within one ulp at the top binade on the max,
    the key-conv bias gradients (zero in exact arithmetic) within
    TRAIN_TOL. With ``pooled`` the per-gradient rule is printed and the
    rule of :func:`within_bf16_spread` is required of all gradients as one
    vector, each normalised as above (phase 5: with dropout the lags' and
    the last gates' distances are rounding noise of the plain step's own
    size, PERF.md). ``witness`` (phase 6), the plain step on the CPU with the
    same masks: the same rounding points, other float32 sum orders. Its
    distance from the plain step is printed beside the kernels', and the
    pooled rule is required on the mean only (at SYNTH the maximum is one
    lag gradient's rounding noise, which the witness also fails; PERF.md)."""
    (k_loss, k_grads), (p_loss, p_grads), (f_loss, f_grads) = kernels, plain, f32
    require(np.isfinite(k_loss) and all(torch.isfinite(g).all().item() for g in k_grads),
            f"{label} on the kernels: non-finite loss or gradient")
    f_by = dict(zip(names, f_grads))
    rows, k_all, q_all, scales = [], [], [], []
    for name, gk, gp, gf in zip(names, k_grads, p_grads, f_grads):
        scale = gf.abs().max().item()
        if name.endswith("key_conv.bias"):
            prefix = name[: -len("key_conv.bias")]
            scale = max(f_by[prefix + c + "_conv.bias"].abs().max().item()
                        for c in ("query", "value", "out"))
        scale = scale if scale > 0 else 1.0  # a parameter the model does not use (a gate)
        scales.append(scale)
        k, q = (gk - gp).abs().double() / scale, (gp - gf).abs().double() / scale
        k_all.append(k.reshape(-1))
        q_all.append(q.reshape(-1))
        k, q = (k.max().item(), k.mean().item()), (q.max().item(), q.mean().item())
        if name.endswith("key_conv.bias"):
            # zero in exact arithmetic: both distances are float32 rounding
            # noise, held to the float32 step's limit
            ok = k[0] <= TRAIN_TOL
        elif any(part in name for part in BF16_ROUNDED_GRADS):
            # rounded to bfloat16 by the layer's backward: one ulp at the top
            # binade is the gradient's resolution
            ulp = 2.0 ** (math.floor(math.log2(scale)) - 7) / scale
            ok = k[0] <= max(q[0], ulp) and k[1] <= 0.5 * q[1]
        else:
            ok = within_bf16_spread(k, q)
        rows.append((name, k, q, ok))
    loss_k, loss_q = abs(k_loss - p_loss), abs(p_loss - f_loss)
    worst = sorted(rows, key=lambda r: -max(r[1][0] / max(r[2][0], 1e-30),
                                            r[1][1] / max(0.5 * r[2][1], 1e-30)))
    print(f"  {label} at batch 32: loss kernels {k_loss:.6f}, plain bfloat16 "
          f"{p_loss:.6f}, float32 {f_loss:.6f} (kernels vs plain {loss_k:.3e}, plain vs float32 "
          f"{loss_q:.3e}); {len(rows)} gradient tensors, kernels vs plain bfloat16 over max "
          f"|float32 gradient| within the plain's distance from float32 (max, and half of it "
          f"on the mean; key-conv biases, zero in exact arithmetic, within {TRAIN_TOL:g}; "
          f"gradients rounded to bfloat16 within one ulp on the max) for "
          f"{sum(r[3] for r in rows)}; closest to the plain's distance: "
          + "; ".join(f"{n} max {k[0]:.2e} / {q[0]:.2e}, mean {k[1]:.2e} / {q[1]:.2e}"
                      f"{'' if ok else ' FAILS'}" for n, k, q, ok in worst[:12]), flush=True)
    require(loss_k <= loss_q, f"{label} loss: kernels {loss_k:.3e} from the plain "
            f"versions, which are {loss_q:.3e} from float32")
    if pooled:
        k_all, q_all = torch.cat(k_all), torch.cat(q_all)
        k = (k_all.max().item(), k_all.mean().item())
        q = (q_all.max().item(), q_all.mean().item())
        print(f"  {label}, the {k_all.numel()} gradient elements as one vector: kernels vs "
              f"plain bfloat16 max {k[0]:.3e} mean {k[1]:.3e}; plain bfloat16 vs float32 max "
              f"{q[0]:.3e} mean {q[1]:.3e}", flush=True)
        if witness is None:
            require(within_bf16_spread(k, q), f"{label} gradients: kernels {k[0]:.3e} (mean "
                    f"{k[1]:.3e}) from the plain versions, which are {q[0]:.3e} (mean "
                    f"{q[1]:.3e}) from float32")
            return
        w_loss, w_grads = witness
        w_all = torch.cat([((gw.to(gp.device) - gp).abs().double() / scale).reshape(-1)
                           for gw, gp, scale in zip(w_grads, p_grads, scales)])
        w = (w_all.max().item(), w_all.mean().item())
        print(f"  {label}, witness: the plain step on the CPU with the same masks vs on the card: "
              f"loss {abs(w_loss - p_loss):.3e}, gradients max {w[0]:.3e} mean {w[1]:.3e}; "
              f"phase 5's rule (max within the plain step's distance from float32, half of it "
              f"on the mean) {'holds' if within_bf16_spread(w, q) else 'fails'} for the "
              f"witness and {'holds' if within_bf16_spread(k, q) else 'fails'} for the kernels; "
              "required here: the mean", flush=True)
        require(k[1] <= 0.5 * q[1], f"{label} gradients: kernels mean {k[1]:.3e} from the "
                f"plain versions, which are mean {q[1]:.3e} from float32")
        return
    for name, k, q, ok in rows:
        require(ok, f"{label} gradient {name}: kernels {k[0]:.3e} (mean {k[1]:.3e}) "
                f"from the plain versions, which are {q[0]:.3e} (mean {q[1]:.3e}) from float32")


@contextlib.contextmanager
def recording(module, name, calls, on=True):
    """While active (and ``on``), ``module.name`` appends its arguments to
    ``calls`` before it runs."""
    fn = getattr(module, name)
    if on:
        setattr(module, name, lambda *args: calls.append(args) or fn(*args))
    try:
        yield
    finally:
        setattr(module, name, fn)


def train_bf16_phase(torch, dev):
    """The bfloat16 train step at PEMS08 width and depth, batch 32: one step
    on the kernels against the same step on the plain bfloat16 versions,
    both held against the float32 step (the reference spread, as the
    bfloat16 Predictor is held in phase 2); each attention sublayer's
    backward teacher-forced on the inputs and cotangent captured in the
    step, with the parent's route as a control that must fail; launches by
    counter and profiler; step time, device time by kernel, idle share; a
    few more steps on the synthetic series, whose loss stays finite.
    Returns the launches of those steps."""
    import dataclasses
    import shutil

    import numpy as np

    from paddlexde_tpu_torch.models.d3stn import Trainer, load_config
    from paddlexde_tpu_torch.ops import _build, attn
    from paddlexde_tpu_torch.ops.timing import time_ms

    PlainTrainer = with_plain_history(Trainer)

    save_dir = HERE / "experiments" / "chip_smoke_bf16"
    shutil.rmtree(save_dir, ignore_errors=True)
    cfg = load_config(str(HERE / "examples" / "configs" / "PEMS08.json"), batch_size=32,
                      compute_dtype="bfloat16", train_epochs=1, finetune_epochs=0,
                      save_dir=str(save_dir))
    adj, sc, data = train_inputs(np, cfg.num_nodes)
    t0 = time.perf_counter()
    tr = Trainer(cfg, data=data, adj_matrix=adj, sc_matrix=sc, device=dev)
    plain = PlainTrainer(dataclasses.replace(cfg, attn_impl="xla", gcn_impl="xla",
                                             save_dir=str(save_dir / "plain")),
                         data=data, adj_matrix=adj, sc_matrix=sc, device=dev)
    f32 = Trainer(dataclasses.replace(cfg, compute_dtype="float32", save_dir=str(save_dir / "f32")),
                  data=data, adj_matrix=adj, sc_matrix=sc, device=dev)
    for other in (plain, f32):
        other.model.load_state_dict(tr.model.state_dict())
    print(f"bfloat16 Trainer: PEMS08 config at batch 32 ({cfg.encoder_num_layers}+"
          f"{cfg.decoder_num_layers} layers, d_model {cfg.d_model}, his_len {cfg.his_len}), "
          f"random parameters (seed {cfg.seed}); built in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 1. one step's loss and gradients on the kernels, on the plain bfloat16
    # versions and in float32, the kernels' bfloat16 backward calls recorded
    starts = next(tr.train_dataset.batch_starts(cfg.batch_size, shuffle=True, seed=cfg.seed))
    src, tgt = tr.windows(starts)
    kl = 1.0
    calls, outs = [], []
    for trainer in (tr, plain, f32):
        with recording(attn, "fused_temporal_attention_bwd_bf16_kernel", calls):
            total, _, _ = trainer.loss_fn(src, tgt, kl)
            grads = torch.autograd.grad(total, trainer.state_tensors(), materialize_grads=True)
        outs.append((total.item(), grads))
    require(len(calls) == LAUNCHES_PER_STEP_BF16["attn_bwd_bf16"],
            f"{len(calls)} bfloat16 attention backward calls in one step")
    check_bf16_step(torch, np, "bfloat16 train step", tr.state_names, *outs)
    del outs, plain, f32

    # 2. teacher-forced: each attention sublayer's backward on the captured
    # inputs and cotangent, and the control
    errs = [attn_bwd_bf16_errors(torch, args) for args in calls]
    controls = [attn_bwd_bf16_errors(torch, args, control=True) for args in calls]
    print(f"  {len(calls)} attention sublayer backwards of the step, K5 bf16 vs the plain "
          f"bfloat16 backward on the captured inputs and cotangent: "
          + ", ".join(f"{e:.3e}" for e in errs) + f" (limit {ATTN_BWD_BF16_TOL:g}); the "
          "control (the parent's route, dx_attn rounded to bfloat16 before the core): "
          + ", ".join(f"{e:.3e}" for e in controls), flush=True)
    require(max(errs) <= ATTN_BWD_BF16_TOL, "a bfloat16 attention sublayer's backward disagrees "
            "with its plain version")
    require(max(controls) > ATTN_BWD_BF16_TOL,
            "the teacher-forced check does not reject the parent's rounding point")
    del calls

    # 3. launches of one step, by counter and by profiler
    lr = (1e-4, 1e-5)
    _build.reset_launches()
    tr.train_step(src, tgt, kl, *lr)
    torch.cuda.synchronize()
    step_launches = dict(_build.LAUNCHES)
    print(f"  launches of one bfloat16 train step (counters): {step_launches}", flush=True)
    require(step_launches == LAUNCHES_PER_STEP_BF16,
            f"one bfloat16 train step launched {step_launches}, expected {LAUNCHES_PER_STEP_BF16}")
    device_us, by_name = traced_launches(torch, lambda: tr.train_step(src, tgt, kl, *lr),
                                         LAUNCHES_PER_STEP_BF16,
                                         "one bfloat16 train step at batch 32")

    # 4. step time
    step_ms = time_ms(lambda: tr.train_step(src, tgt, kl, *lr), reps=10)
    by_kernel = {k: sum(us for name, us in by_name.items()
                        if any(sym in name for sym in KERNEL_NAMES[k])) / 1e3
                 for k in KERNEL_NAMES}
    print(f"  bfloat16 train step at batch 32 (CUDA events, median of 10): {step_ms:.3f} ms "
          f"({32e3 / step_ms:.1f} samples/s); device time in the trace {device_us / 1e3:.3f} ms "
          f"(idle share {1 - device_us / 1e3 / step_ms:.1%} of the event-timed step); by kernel "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in by_kernel.items() if v)
          + f", other {device_us / 1e3 - sum(by_kernel.values()):.3f} ms", flush=True)

    # 5. a few more steps on other windows
    batches = list(tr.train_dataset.batch_starts(cfg.batch_size, shuffle=True, seed=1,
                                                 drop_last=True))[:BF16_STEPS]
    _build.reset_launches()
    losses = [tr.train_step_idx(s_b, kl, *lr)[0] for s_b in batches]
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    losses = torch.stack(losses).cpu().numpy()
    print(f"  {len(batches)} more bfloat16 train steps: losses {losses.tolist()}; launches "
          f"{launches}", flush=True)
    require(np.isfinite(losses).all(), "a bfloat16 train step gave a non-finite loss")
    require(launches == {k: len(batches) * v for k, v in LAUNCHES_PER_STEP_BF16.items()},
            f"{len(batches)} bfloat16 train steps launched {launches}")
    shutil.rmtree(save_dir, ignore_errors=True)
    return launches, device_us / 1e3


def bf16_p_then_mask(torch, orig):
    """``_attention_core_bf16`` whose value product takes bf16(p) m (the mask
    after the rounding) instead of bf16(p m): the dropout control."""
    from paddlexde_tpu_torch.ops import attn

    def core(q, k, v, is_mask, heads, dropout_mask=None):
        _, p = orig(q, k, v, is_mask, heads)
        b, n, t_q, d = q.shape
        vh = v.float().reshape(b, n, -1, heads, d // heads)
        p_eff = p.to(torch.bfloat16).float() * attn._head_major(dropout_mask, heads)
        x = torch.einsum("bnqhk,bnkhd->bnqhd", p_eff, vh)
        return x.to(torch.bfloat16).reshape(b, n, t_q, d), p

    return core


def teacher_forced_dropout(torch, fwd_calls, bwd_calls):
    """Each bfloat16 dropout attention sublayer of a step teacher-forced: K4
    bf16 dropout on the captured inputs and mask against the plain bfloat16
    forward (one ulp on at most BF16_SHARE of elements), with the mask
    applied after the rounding as a control that must fail; K5 bf16 dropout
    on the captured inputs, cotangent and mask against the plain bfloat16
    backward (ATTN_BWD_BF16_TOL)."""
    from paddlexde_tpu_torch.ops import attn
    from paddlexde_tpu_torch.ops.compare import bf16_errors

    require(len(fwd_calls) == len(bwd_calls) == 6,
            f"{len(fwd_calls)} / {len(bwd_calls)} bfloat16 dropout attention calls in one step")
    fwd, ctl = [], []
    orig = attn._attention_core_bf16
    with torch.no_grad():
        for args in fwd_calls:
            *inputs, mask = args
            got = attn.fused_temporal_attention_bf16_kernel(*args)
            err, ulp, share = bf16_errors(got, attn.fused_temporal_attention_plain(
                *inputs, "bfloat16", mask))
            fwd.append((err / ulp, share))
            attn._attention_core_bf16 = bf16_p_then_mask(torch, orig)
            try:
                err, ulp, share = bf16_errors(got, attn.fused_temporal_attention_plain(
                    *inputs, "bfloat16", mask))
            finally:
                attn._attention_core_bf16 = orig
            ctl.append((err / ulp, share))
    bwd = [max(attn.bwd_errors(attn.fused_temporal_attention_bwd_bf16_kernel(*args),
                               attn.fused_temporal_attention_bwd_plain(*args[:16], "bfloat16",
                                                                       args[16])))
           for args in bwd_calls]
    print("  teacher-forced, the step's 6 bfloat16 dropout attention sublayers: K4 vs plain "
          + ", ".join(f"{r:.2f} ulp on {s:.3%}" for r, s in fwd) + "; the control (the mask "
          "after the rounding) " + ", ".join(f"{r:.2f} ulp on {s:.3%}" for r, s in ctl)
          + "; K5 vs plain " + ", ".join(f"{e:.3e}" for e in bwd)
          + f" (limit {ATTN_BWD_BF16_TOL:g})", flush=True)
    require(all(r <= 1 and s <= BF16_SHARE for r, s in fwd),
            "a bfloat16 dropout attention sublayer disagrees with its plain forward")
    require(not all(r <= 1 and s <= BF16_SHARE for r, s in ctl),
            "the teacher-forced dropout check does not reject the mask after the rounding")
    require(max(bwd) <= ATTN_BWD_BF16_TOL,
            "a bfloat16 dropout attention sublayer's backward disagrees with its plain version")


class CardMasks:
    """A CPU model's mask source that draws each site's keep mask on the card
    (``DropoutMasks`` seeds a generator per site on the device it is asked
    for) and hands it to the CPU: the masks of the card's trainers."""

    def __init__(self, masks, dev):
        self.masks, self.dev = masks, dev

    def set_step(self, seed):
        self.masks.set_step(seed)

    def start(self):
        self.masks.start()

    def keep(self, shape, keep, device):
        return self.masks.keep(shape, keep, self.dev).to(device)


def train_dropout_phase(torch, dev, config="PEMS08"):
    """Training at dropout DROPOUT, ``config`` width and depth, batch 32, in
    float32 and then in bfloat16. Per dtype: one step on the kernels against
    the same step on the plain versions with the same masks (both trainers'
    mask sources seeded for the same step), under phase 3's rule in float32
    and phase 4's in bfloat16 (against the float32 step with the same
    masks); the launches of a step by counter and profiler (the dropout
    forms of K4 and K5, no K2 and no K3); the step time; DROPOUT_STEPS more
    steps with their own masks and a finite loss. At SYNTH (phase 6) the
    bfloat16 step's gradients are also held against a witness, the plain
    step on the CPU with the same masks (:func:`check_bf16_step`). Returns,
    per dtype, the launches of those steps and the traced step's device time
    (ms)."""
    import dataclasses
    import shutil

    import numpy as np

    from paddlexde_tpu_torch.models.d3stn import Trainer, load_config
    from paddlexde_tpu_torch.models.d3stn.model import DropoutMasks
    from paddlexde_tpu_torch.ops import _build, attn
    from paddlexde_tpu_torch.ops.timing import time_ms

    PlainTrainer = with_plain_history(Trainer)
    save_dir = HERE / "experiments" / f"chip_smoke_dropout_{config}"
    shutil.rmtree(save_dir, ignore_errors=True)
    cfg = load_config(str(HERE / "examples" / "configs" / f"{config}.json"), batch_size=32,
                      dropout=DROPOUT, train_epochs=1, finetune_epochs=0)
    adj, sc, data = train_inputs(np, cfg.num_nodes)
    results = {}
    for dtype in ("float32", "bfloat16"):
        bf16 = dtype == "bfloat16"
        dcfg = dataclasses.replace(cfg, compute_dtype=dtype, save_dir=str(save_dir / dtype))
        t0 = time.perf_counter()
        tr = Trainer(dcfg, data=data, adj_matrix=adj, sc_matrix=sc, device=dev)
        others = [PlainTrainer(dataclasses.replace(dcfg, attn_impl="xla", gcn_impl="xla",
                                                   save_dir=str(save_dir / f"{dtype}_plain")),
                               data=data, adj_matrix=adj, sc_matrix=sc, device=dev)]
        if bf16:
            others.append(Trainer(dataclasses.replace(dcfg, compute_dtype="float32",
                                                      save_dir=str(save_dir / f"{dtype}_f32")),
                                  data=data, adj_matrix=adj, sc_matrix=sc, device=dev))
        if bf16 and config == "SYNTH":
            others.append(Trainer(dataclasses.replace(dcfg, attn_impl="xla", gcn_impl="xla",
                                                      save_dir=str(save_dir / f"{dtype}_cpu")),
                                  data=data, adj_matrix=adj, sc_matrix=sc, device="cpu"))
            others[-1].model.dropout_masks = CardMasks(DropoutMasks(dcfg.seed), dev)
        for other in others:
            other.model.load_state_dict(tr.model.state_dict())
        print(f"{dtype} Trainer at dropout {cfg.dropout}: {config} config at batch 32 "
              f"({cfg.encoder_num_layers}+{cfg.decoder_num_layers} layers, d_model "
              f"{cfg.d_model}), random parameters (seed {cfg.seed}); built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        # 1. one step's loss and gradients with the same masks
        starts = next(tr.train_dataset.batch_starts(cfg.batch_size, shuffle=True, seed=cfg.seed))
        src, tgt = tr.windows(starts)
        kl = 1.0
        outs, fwd_calls, bwd_calls = [], [], []
        for trainer in (tr, *others):
            trainer.set_dropout_step(0, 0)
            on_cpu = trainer.device.type == "cpu"
            with recording(attn, "fused_temporal_attention_bf16_kernel", fwd_calls,
                           trainer is tr and bf16), \
                    recording(attn, "fused_temporal_attention_bwd_bf16_kernel", bwd_calls,
                              trainer is tr and bf16):
                total, _, _ = trainer.loss_fn(src.cpu() if on_cpu else src,
                                              tgt.cpu() if on_cpu else tgt, kl)
                grads = torch.autograd.grad(total, trainer.state_tensors(),
                                            materialize_grads=True)
            outs.append((total.item(), grads))
        if bf16:
            check_bf16_step(torch, np, f"{config} bfloat16 dropout train step", tr.state_names,
                            *outs[:3], pooled=True, witness=outs[3] if len(outs) > 3 else None)
            teacher_forced_dropout(torch, fwd_calls, bwd_calls)
        else:
            (k_loss, k_grads), (p_loss, p_grads) = outs
            loss_err = abs(k_loss - p_loss) / abs(p_loss)
            errs = grad_errors(tr.state_names, k_grads, p_grads)
            worst = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
            print(f"  {config} float32 dropout train step at batch 32, kernels vs plain versions "
                  f"on the card with the same masks: loss {k_loss:.6f} vs {p_loss:.6f}, "
                  f"relative err "
                  f"{loss_err:.3e}; {len(errs)} gradient tensors, max normalised err "
                  f"{worst[0][1]:.3e} (tol {TRAIN_TOL:g}); largest: "
                  + ", ".join(f"{k} {v:.2e}" for k, v in worst), flush=True)
            require(np.isfinite(k_loss) and all(torch.isfinite(g).all().item() for g in k_grads),
                    "dropout train step on the kernels: non-finite loss or gradient")
            require(loss_err <= TRAIN_TOL, f"dropout train-step loss differs: {loss_err:.3e}")
            require(worst[0][1] <= TRAIN_TOL,
                    f"dropout train-step gradient {worst[0][0]} differs: {worst[0][1]:.3e}")
        del outs, others

        # 2. launches of one step, by counter and by profiler
        per_step = LAUNCHES_PER_STEP_DROPOUT_BF16 if bf16 else LAUNCHES_PER_STEP_DROPOUT
        lr = (1e-4, 1e-5)
        _build.reset_launches()
        tr.set_dropout_step(0, 0)
        tr.train_step(src, tgt, kl, *lr)
        torch.cuda.synchronize()
        step_launches = dict(_build.LAUNCHES)
        print(f"  launches of one {dtype} dropout train step (counters): {step_launches}",
              flush=True)
        require(step_launches == per_step,
                f"one {dtype} dropout train step launched {step_launches}, expected {per_step}")
        device_us, by_name = traced_launches(torch, lambda: tr.train_step(src, tgt, kl, *lr),
                                             per_step, f"one {config} {dtype} dropout train step",
                                             d64=cfg.d_model == 64)

        # 3. step time
        step_ms = time_ms(lambda: tr.train_step(src, tgt, kl, *lr), reps=10)
        by_kernel = {k: sum(us for name, us in by_name.items()
                            if any(sym in name for sym in KERNEL_NAMES[k])) / 1e3
                     for k in KERNEL_NAMES}
        print(f"  {dtype} dropout train step at batch 32 (CUDA events, median of 10): "
              f"{step_ms:.3f} ms ({32e3 / step_ms:.1f} samples/s); device time in the trace "
              f"{device_us / 1e3:.3f} ms (idle share {1 - device_us / 1e3 / step_ms:.1%} of the "
              f"event-timed step); by kernel "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in by_kernel.items() if v)
              + f", other {device_us / 1e3 - sum(by_kernel.values()):.3f} ms", flush=True)

        # 4. more steps on other windows, each with its own masks
        batches = list(tr.train_dataset.batch_starts(cfg.batch_size, shuffle=True, seed=1,
                                                     drop_last=True))[:DROPOUT_STEPS]
        _build.reset_launches()
        losses = []
        for i, s_b in enumerate(batches):
            tr.set_dropout_step(1, i)
            losses.append(tr.train_step_idx(s_b, kl, *lr)[0])
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        losses = torch.stack(losses).cpu().numpy()
        print(f"  {len(batches)} more {dtype} dropout train steps: losses {losses.tolist()}; "
              f"launches {launches}", flush=True)
        require(np.isfinite(losses).all(), f"a {dtype} dropout train step gave a non-finite loss")
        require(launches == {k: len(batches) * v for k, v in per_step.items()},
                f"{len(batches)} {dtype} dropout train steps launched {launches}")
        results[dtype] = (launches, device_us / 1e3)
        del tr
    shutil.rmtree(save_dir, ignore_errors=True)
    return results


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
    serve_launches, f32_ms, f32_outs = predictor_phase(torch, dev)
    bf16_launches, bf16_ms, _ = predictor_phase(torch, dev, "bfloat16", f32_outs)
    print(f"serving device time per batch of 32: float32 {f32_ms:.3f} ms, bfloat16 "
          f"{bf16_ms:.3f} ms", flush=True)
    train_launches, _ = train_phase(torch, dev)
    bf16_train_launches, bf16_step_ms = train_bf16_phase(torch, dev)
    print(f"bfloat16 train step device time at batch 32: {bf16_step_ms:.3f} ms", flush=True)
    dropout = train_dropout_phase(torch, dev)
    print("dropout train step device time at batch 32: "
          + ", ".join(f"{dtype} {ms:.3f} ms" for dtype, (_, ms) in dropout.items()), flush=True)
    # phase 6: SYNTH (D = 64, 4 heads, N = 16, with_adj) served and trained
    synth_serve, synth_serve_ms, _ = predictor_phase(torch, dev, config="SYNTH")
    synth_train, synth_step_ms = train_phase(torch, dev, "SYNTH", epochs=False)
    synth_dropout = train_dropout_phase(torch, dev, "SYNTH")
    print(f"SYNTH device time at batch 32: serving {synth_serve_ms:.3f} ms, float32 train step "
          f"{synth_step_ms:.3f} ms, dropout train step "
          + ", ".join(f"{dtype} {ms:.3f} ms" for dtype, (_, ms) in synth_dropout.items()),
          flush=True)
    pems = [serve_launches, bf16_launches, train_launches, bf16_train_launches,
            *(d[0] for d in dropout.values())]
    synth = [synth_serve, synth_train, *(d[0] for d in synth_dropout.values())]
    launches = {}
    for name in kernels:
        if name.endswith("_d64"):  # the float32 attention forward at SYNTH's D = 64
            launches[name] = sum(run[name[: -len("_d64")]] for run in synth)
        elif name in ("attn_fwd", "attn_fwd_dropout"):  # at PEMS08's D = 128
            launches[name] = sum(run[name] for run in pems)
        else:
            launches[name] = sum(run[name] for run in pems + synth)
    for name in kernels:
        require(launches[name] > 0, f"{name} was never launched on the main paths")
    print(card)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k][0], "replaces": SOURCES[k][1],
         "launches": launches[k], "max_abs_err": v["err"], "ms": v["ms"],
         "plain_ms": v["plain_ms"], "bound_ms": v["bound_main"][0],
         "bound_by": v["bound_main"][1], "library_ms": None}
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
