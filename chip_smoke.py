#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card: D3STN serving and training, the
adaptive ODE solvers on bench.py's spiral neural ODE, the rest of D3STN
and the DDE extras (a reference checkpoint, the training CLI,
``ddeint_adjoint``, ``ddeint_mos``, ``prefetch``), the rest of the ODE
solver zoo (stiff, event, symplectic, Adams, per-element and CNF
workloads), and the CDE half and the SDE core (the Brownian tree,
``sdeint``, ``cdeint``, the log-ODE method).

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
forward, with or without dropout, spills or has no HGMMA), and runs ten
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
   the float32 attention forward as ``attn_fwd_d3stn_kernel<64, ...>``;
7. bench.py's spiral neural ODE (``spiral_phase``; no kernel of its own,
   and it must launch none of the port's): ``odeint`` with dopri5 at rtol
   1e-6 / atol 1e-8 over [0, 25] at 1000 outputs in float32, on the
   buffered-dense and the per-output engine, against the port's float64
   solve on the CPU (SPIRAL_FWD_TOL), with one host read per attempted step
   (the engine's counter); in float64 on the card the CPU's step counts and
   values (SPIRAL_F64_TOL); the 4096-trajectory batch on every 64th row
   (SPIRAL_BATCH_TOL); the gradient of sum |y(t1)| through the dense
   engine and by ``odeint_adjoint`` over [0, 25] with the mixed norm and
   the seminorm, in float32 and float64 against the CPU's float64 gradient
   (SPIRAL_GRAD_TOL), the seminorm backward with fewer field evaluations;
   then the host-clock and CUDA-event time of a solve, dopri5 steps/s, host
   reads per step, the idle share and the adjoint's backward/forward ratio
   with each norm, beside the card's name and power limit and the JAX
   package's TPU figures from ``BENCH_r05.json`` (labelled as such);
8. the rest of D3STN and the DDE extras (``dde_extras_phase``): (a) a
   reference-format (PaddleXDE) PEMS08 state dict made from a seed,
   converted by ``convert_reference_state_dict`` with nothing unmatched,
   served through ``Predictor`` on the kernels against the same weights
   through the plain versions on the card and the CPU forward
   (PREDICTOR_TOL); (b) the training CLI
   (``paddlexde_tpu_torch.examples.train_d3stn``, ``--synthetic``, one
   main and one finetune epoch): finite test metrics, the launches of
   K1-K5 equal to the epochs' steps and eval and test batches, each
   epoch's time; (c) ``ddeint_adjoint`` through D3STN's field at PEMS08
   width and depth, batch 32, euler on [0, 1] and rk4 at step 0.25: the
   gradients to every parameter and both lag sets on the kernels against
   the plain versions (TRAIN_TOL), each checked call's launches equal to
   its field calls' (``adjoint_launches``), K1's lag gradient, K3 and K5 in
   a profiler trace, the peak memory (below direct autograd's at rk4) and
   time of forward + backward against ``ddeint``, and the adjoint-direct
   gradient gap; (d) ``ddeint_mos`` on MOS_BATCH trajectories: the closed
   form of y' = -y(t - 1) in float32 and float64, Mackey-Glass with a
   tensor and a callable lag and its gradients against the CPU's float64
   solve, at most one host sync a solve (CUDA's sync debug mode), launches
   a step and steps/s; (e) ``prefetch`` from a pinned host buffer that is
   refilled: every item equals its snapshot, an early close stops the
   producer. It prints phase 8's launches by kernel;
9. the rest of the ODE solver zoo (``ode_zoo_phase``; no kernel of its own,
   and it must launch none of the port's), the JAX package's own workloads
   at full size, in float32 unless marked, each against the port's float64
   solve on the CPU: (a) Robertson's kinetics on the demo's grid with
   sdirk2, kvaerno3, sdirk4 and trbdf2 and SciPy's LSODA from a float64
   card state (mass drift below 1e-5, species against an LSODA solve at
   rtol 1e-10, one host read per attempted step), and the kvaerno3
   ``odeint_adjoint`` gradient to the rate constants against direct
   autograd (float64); (b) Fisher-KPP fronts, D = 256 by unpreconditioned
   implicit-Euler Newton-Krylov against the CPU, D = 8191 by implicit Euler
   and SDIRK2 Newton-Krylov with the Dirichlet heat preconditioner (front
   coverage advancing, the preconditioned Newton residual); (c) the
   bouncing ball's event time and ``odeint_event_grad``'s dt*/dh0 against
   the closed forms; (d) yoshida4, leapfrog and rk4 on the pendulum over
   1e4 steps (yoshida4's energy error bounded, rk4's growing past it) and
   the Adams solvers on bench.py's spiral; (e) ``odeint_per_element`` on
   4096 elements with a stiffness spread of 1..160 (nfe spread, one host
   read per controller step and no other sync), the exact-divergence CNF
   over 2048 samples with rk4, and ``torch.func.jvp`` through dopri5
   against a central difference. Each run prints its host-clock time
   (under the profiler), steps/s, host syncs with their lines, device time,
   launches per step and the idle share (the pendulum's from its first 200
   steps, the Krylov fronts' from their first step, scaled);
10. CDEs and the SDE core (``sde_cde_phase``; no kernel of its own, and it
   must launch none of the port's), the JAX package's SDE and CDE examples
   at full size, float32 unless marked: the launches and host time of one
   Brownian query in each tree mode; (a) the noisy spiral of
   ``examples/sde_demo.py`` (4096 paths, 1000 outputs over [0, 25], key 0)
   with euler, milstein, sriw1 and heun_stratonovich, the first 64 paths
   held against the CPU's float32 solve and its float64 solve of the same
   path (float32 normals, ``virtual_tree._noise_dtype``) over the first 250
   steps and, from the card's state, over the last 250, and the tree's W
   against both; (b) strong
   orders in float64 on the card: euler and milstein on GBM against its
   closed form (dt 2^-4..2^-8, 4096 paths, within ORDER_BAND of 0.5 and
   1.0), sra1 against itself at dt / 64 (dt 2^-2..2^-4, within
   SRA1_ORDER), milstein's
   float64 path against the CPU's; (c) ``examples/sde_general_demo.py``'s
   milstein_general with Davie areas (2048 paths, key 42), its terminal
   log-return covariance within 4 standard errors of L L^T, and foster2
   on the (W, I10, K) tree; (d) ``examples/cde_demo.py``'s neural CDE on
   4096 samples, its loss and parameter gradient by autograd and by
   ``adjoint=True`` with the peak memory of each; (e)
   ``examples/logode_dde_demo.py``'s log-ODE over a 4096-knot walk at
   depth 1, 2, 3 against the fine oracle (float64, on the CPU; the error
   must fall with depth), and the natural spline's build over the same
   knots. Each run prints its agreement, steps/s, launches a step (long
   runs: from a profiled run of their first steps), host syncs and the
   idle share.

Launch counts are checked by the wrappers' counters and by ``torch.profiler``
traces. It prints:

- the card's name and power limit (``nvidia-smi``);
- one JSON line ``{"kernels": [...]}`` with each kernel's launches on the
  main paths (serving in float32 and in bfloat16, the two-epoch train, the
  bfloat16 train steps and the dropout train steps, phase 6's and phase
  8's (the CLI's with phase 6's, at D = 64); the
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


# --------------------------------------------------------------------------
# phase 7: bench.py's spiral neural ODE -- adaptive odeint and odeint_adjoint
# on the card (no kernel of its own: PyTorch's ops under a host loop)
# --------------------------------------------------------------------------

# bench.py's problem (BENCH_CONFIG, bench.py:26-33 and :83-103)
SPIRAL = {"rtol": 1e-6, "atol": 1e-8, "t1": 25.0, "n_points": 1000, "max_steps": 512,
          "batch": 4096}
# the card's float32 solve against the port's float64 solve on the CPU with
# the same tolerances, max |diff| over the solution's max |value|: the two
# take different step sequences (float32 rounding moves the step control),
# each with a global error of a few rtol over 25 time units (the CPU's own
# float32 solve: 7.7e-6, its error against an rtol 1e-11 solve 9.3e-6)
SPIRAL_FWD_TOL = 2e-5
# bench.py's 4096 trajectories share one step control (RMS over 8192
# values), so a single row may sit further from its own reference than the
# RMS controls; every 64th row against the float64 solve of those rows with
# the same tolerances (CPU float32: 1.5e-5 of the rows' scale from an rtol
# 1e-10 solve)
SPIRAL_BATCH_TOL = 5e-5
# gradients of sum |y(t1)|, per tensor, max |diff| over its max |value|: in
# float32 against the CPU's float64 gradient (other grids: on the CPU the
# float32 gradient differs from the float64 one by up to 3.5e-2, the
# adjoint's from the direct one by as much); in float64 the card's
# gradient against the CPU's on the same step sequence, where the two sum
# in other orders (the card's stage sums are a product and a sum, the
# CPU's a tensordot; cuBLAS against the CPU's matmul) and 25 time units of
# the spiral amplify those roundings (4.1e-9 on the first card run)
SPIRAL_GRAD_TOL = {"float32": 0.1, "float64": 1e-7}
# the card's float64 forward against the CPU's on the same step sequence,
# for the same reason (9.2e-13 on the first card run)
SPIRAL_F64_TOL = 2e-11
# the JAX package on a TPU (BENCH_r05.json, float32), printed for reference:
# not a figure of the port
BENCH_R05_TPU = {"nfe": 277, "solver_steps": 46, "adjoint_bwd_fwd_ratio": 95.28,
                 "adjoint_bwd_fwd_ratio_seminorm": 8.588}


def spiral_problem(torch, dtype, device, requires_grad=False):
    """bench.py's parameters and 4096 initial states, from one
    ``np.random.RandomState(0)`` in its order (w1, w2, the batch)."""
    import numpy as np

    rng = np.random.RandomState(0)
    w1 = rng.randn(2, 50).astype(np.float32) * 0.1
    w2 = rng.randn(50, 2).astype(np.float32) * 0.1
    big = rng.randn(SPIRAL["batch"], 2).astype(np.float32) * 0.5
    params = {"w1": w1, "b1": np.zeros(50, np.float32), "w2": w2, "b2": np.zeros(2, np.float32)}
    params = {k: torch.tensor(v, dtype=dtype, device=device, requires_grad=requires_grad)
              for k, v in params.items()}
    return params, torch.tensor(big, dtype=dtype, device=device)


def spiral_field(torch, p):
    return lambda t, y: torch.tanh((y**3) @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def spiral_solve(torch, dtype, device, y0=None, dense=True, params=None):
    from paddlexde_tpu_torch import odeint

    p = params if params is not None else spiral_problem(torch, dtype, device)[0]
    if y0 is None:
        y0 = torch.tensor([[2.0, 0.0]], dtype=dtype, device=device)
    t = torch.linspace(0.0, SPIRAL["t1"], SPIRAL["n_points"], dtype=dtype, device=device)
    options = {"return_stats": True}
    if dense:
        options["max_steps"] = SPIRAL["max_steps"]
    return odeint(spiral_field(torch, p), y0, t, "dopri5", rtol=SPIRAL["rtol"],
                  atol=SPIRAL["atol"], options=options, time_axis=0)


def spiral_loss_grads(torch, dtype, device, adjoint_norm=None):
    """Gradients of sum |y(t1)| to (w1, b1, w2, b2, y0): through the
    buffered-dense engine (``adjoint_norm`` None) or by ``odeint_adjoint``
    over [0, t1] with that norm ("mixed" or "seminorm")."""
    from paddlexde_tpu_torch import odeint, odeint_adjoint

    p, _ = spiral_problem(torch, dtype, device, requires_grad=True)
    y0 = torch.tensor([[2.0, 0.0]], dtype=dtype, device=device, requires_grad=True)
    f = spiral_field(torch, p)
    kw = {"rtol": SPIRAL["rtol"], "atol": SPIRAL["atol"], "time_axis": 0}
    if adjoint_norm is None:
        t = torch.linspace(0.0, SPIRAL["t1"], SPIRAL["n_points"], dtype=dtype, device=device)
        ys = odeint(f, y0, t, "dopri5", options={"max_steps": SPIRAL["max_steps"]}, **kw)
    else:
        t = torch.tensor([0.0, SPIRAL["t1"]], dtype=dtype, device=device)
        ys = odeint_adjoint(f, y0, t, "dopri5", adjoint_params=tuple(p.values()),
                            adjoint_options={"norm": adjoint_norm}, **kw)
    ys[-1].abs().sum().backward()
    return [p[k].grad for k in ("w1", "b1", "w2", "b2")] + [y0.grad]


def spiral_grad_errors(got, want):
    return [norm_err(g.double().cpu(), w.double()) for g, w in zip(got, want)]


def host_clock_ms(torch, fn, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times)


def spiral_phase(torch, dev):
    """Phase 7 (module docstring): the forward on both adaptive engines, the
    batch, the direct and adjoint gradients against the port's float64 solve
    on the CPU; float64 on the card against the CPU on the same steps; times
    and host reads per step. Returns the summary figures."""
    from paddlexde_tpu_torch.functional.odeint_adjoint import BACKWARD_STATS
    from paddlexde_tpu_torch.ops import _build
    from paddlexde_tpu_torch.ops.timing import device_profile, time_ms
    from paddlexde_tpu_torch.solver import adaptive

    f32, f64, cpu = torch.float32, torch.float64, torch.device("cpu")
    _build.reset_launches()
    out = {}
    print("phase 7: the spiral neural ODE of bench.py (dopri5, rtol 1e-6, atol 1e-8, "
          "t in [0, 25] at 1000 outputs; TF32 off)", flush=True)

    # 1. forward: both engines on the card in float32 against the CPU's
    # float64 solve; float64 on the card against the CPU's, stats equal
    for dense in (True, False):
        engine = "buffered-dense (max_steps 512)" if dense else "per-output"
        ref, ref_stats = spiral_solve(torch, f64, cpu, dense=dense)
        cpu32, cpu32_stats = spiral_solve(torch, f32, cpu, dense=dense)
        adaptive.reset_host_reads()
        got, stats = spiral_solve(torch, f32, dev, dense=dense)
        reads = dict(adaptive.HOST_READS)
        err = norm_err(got.double().cpu(), ref)
        require(got.shape == (SPIRAL["n_points"], 1, 2) and bool(torch.isfinite(got).all()),
                f"spiral {engine}: shape {tuple(got.shape)} or non-finite values")
        require(stats.status == 0, f"spiral {engine}: status {stats.status}")
        require(err <= SPIRAL_FWD_TOL, f"spiral {engine}: float32 on the card is {err:.3e} from "
                f"the CPU float64 solve, limit {SPIRAL_FWD_TOL}")
        attempted = stats.n_accept + stats.n_reject
        require(reads["step"] == attempted and reads["setup"] <= 1,
                f"spiral {engine}: {reads} host reads for {attempted} attempted steps")
        got64, stats64 = spiral_solve(torch, f64, dev, dense=dense)
        err64 = norm_err(got64.cpu(), ref)
        require(tuple(stats64) == tuple(ref_stats) and err64 <= SPIRAL_F64_TOL,
                f"spiral {engine} float64: card stats {tuple(stats64)}, CPU {tuple(ref_stats)}, "
                f"values {err64:.3e} apart (limit {SPIRAL_F64_TOL})")
        print(f"  forward, {engine}: float32 on the card (nfe, accepted, rejected, status) "
              f"{tuple(stats)}, {err:.3e} of the solution's scale from the CPU float64 solve "
              f"(limit {SPIRAL_FWD_TOL}); the port's float32 on the CPU {tuple(cpu32_stats)}; "
              f"float64 on the card {tuple(stats64)} = CPU float64 {tuple(ref_stats)}, "
              f"{err64:.3e} apart; host reads {reads['step']} in the loop for {attempted} "
              f"attempted steps + {reads['setup']} of t_span", flush=True)
        if dense:
            out.update(stats=stats, cpu32_stats=cpu32_stats, stats64=stats64, fwd_err=err)
    print(f"  for reference, the JAX package on a TPU (BENCH_r05.json, float32): nfe "
          f"{BENCH_R05_TPU['nfe']}, {BENCH_R05_TPU['solver_steps']} steps", flush=True)

    # 2. the batch of 4096 trajectories (one shared step control)
    p32, big = spiral_problem(torch, f32, dev)
    p64, big64 = spiral_problem(torch, f64, cpu)
    yb, stats_b = spiral_solve(torch, f32, dev, y0=big, params=p32)
    rows = torch.arange(0, SPIRAL["batch"], 64)
    ref_b, _ = spiral_solve(torch, f64, cpu, y0=big64[rows], params=p64)
    err_b = norm_err(yb[:, rows.to(dev)].double().cpu(), ref_b)
    require(yb.shape == (SPIRAL["n_points"], SPIRAL["batch"], 2) and bool(torch.isfinite(yb).all())
            and stats_b.status == 0, f"spiral batch: shape {tuple(yb.shape)}, stats {stats_b}")
    require(err_b <= SPIRAL_BATCH_TOL, f"spiral batch: rows {err_b:.3e} from their CPU float64 "
            f"solve, limit {SPIRAL_BATCH_TOL}")
    print(f"  batch of {SPIRAL['batch']}: stats {tuple(stats_b)}, every 64th row {err_b:.3e} of "
          f"the rows' scale from their CPU float64 solve (limit {SPIRAL_BATCH_TOL})", flush=True)

    # 3. the direct gradient through the buffered-dense engine, 4. the
    # adjoint with the mixed norm and the seminorm
    names = ("w1", "b1", "w2", "b2", "y0")
    nfe_bwd = {}
    for label, norm in (("direct", None), ("adjoint, mixed norm", "mixed"),
                        ("adjoint, seminorm", "seminorm")):
        want = spiral_loss_grads(torch, f64, cpu, norm)
        want_stats = dict(BACKWARD_STATS)
        for dtype in (f32, f64):
            key = str(dtype).split(".")[-1]
            errs = spiral_grad_errors(spiral_loss_grads(torch, dtype, dev, norm), want)
            tol = SPIRAL_GRAD_TOL[key]
            require(all(e <= tol for e in errs), f"spiral {label} gradient, {key} on the card: "
                    f"{dict(zip(names, errs))} from the CPU float64 gradient, limit {tol}")
            if norm is not None and dtype == f32:
                nfe_bwd[norm] = dict(BACKWARD_STATS)
            print(f"  {label} gradient, {key} on the card: max error per tensor "
                  f"{max(errs):.3e} (limit {tol}; "
                  + ", ".join(f"{n} {e:.2e}" for n, e in zip(names, errs)) + ")"
                  + (f"; backward {dict(BACKWARD_STATS)}, the CPU's float64 backward "
                     f"{want_stats}" if norm is not None else ""), flush=True)
    require(nfe_bwd["seminorm"]["nfe"] < nfe_bwd["mixed"]["nfe"],
            f"spiral adjoint: the seminorm backward took {nfe_bwd['seminorm']['nfe']} field "
            f"evaluations, the mixed norm's {nfe_bwd['mixed']['nfe']}")
    out["nfe_bwd"] = nfe_bwd

    launched = {k: v for k, v in _build.LAUNCHES.items() if v}
    require(not launched, f"phase 7 launched port kernels: {launched}")

    # 5. times (figures, not limits)
    if dev.type == "cuda":
        def solve():
            spiral_solve(torch, f32, dev)

        host_ms = host_clock_ms(torch, solve)
        event_ms = time_ms(solve, reps=5, warmup=1)
        device_ms, kernels_per_solve, _ = device_profile(solve, reps=3, traces=1)
        attempted = out["stats"].n_accept + out["stats"].n_reject
        adaptive.reset_host_reads()
        solve()
        reads = adaptive.HOST_READS["step"] + adaptive.HOST_READS["setup"]
        ratio = {}
        for norm in ("mixed", "seminorm"):
            from paddlexde_tpu_torch import odeint_adjoint

            p, _ = spiral_problem(torch, f32, dev, requires_grad=True)
            y0 = torch.tensor([[2.0, 0.0]], device=dev, requires_grad=True)
            t = torch.tensor([0.0, SPIRAL["t1"]], device=dev)

            def fwd(backward=False, p=p, y0=y0, t=t, norm=norm):
                ys = odeint_adjoint(spiral_field(torch, p), y0, t, "dopri5", rtol=SPIRAL["rtol"],
                                    atol=SPIRAL["atol"], adjoint_params=tuple(p.values()),
                                    adjoint_options={"norm": norm}, time_axis=0)
                if backward:
                    ys[-1].abs().sum().backward()

            fwd_ms = host_clock_ms(torch, fwd, reps=3)
            fb_ms = host_clock_ms(torch, lambda: fwd(True), reps=3)
            ratio[norm] = (fb_ms - fwd_ms) / fwd_ms
            print(f"  adjoint ({norm}): forward {fwd_ms:.2f} ms, forward + backward {fb_ms:.2f} ms "
                  f"(host clock, median of 3): backward/forward {ratio[norm]:.2f}", flush=True)
        out.update(host_ms=host_ms, event_ms=event_ms, device_ms=device_ms,
                   steps_per_s=attempted / (host_ms / 1e3), reads_per_step=reads / attempted,
                   idle=1 - device_ms / event_ms, ratio=ratio)
        print(f"  one float32 solve (buffered-dense, 1000 outputs, {attempted} attempted steps): "
              f"host clock {host_ms:.2f} ms, CUDA events {event_ms:.2f} ms, device time "
              f"{device_ms:.3f} ms in {kernels_per_solve:.0f} kernel launches (idle share "
              f"{out['idle']:.1%}); {out['steps_per_s']:.0f} dopri5 steps/s; {reads} host reads, "
              f"{out['reads_per_step']:.3f} per attempted step; card {card_line()}", flush=True)
        print(f"  for reference, the JAX package on a TPU (BENCH_r05.json): adjoint "
              f"backward/forward {BENCH_R05_TPU['adjoint_bwd_fwd_ratio']} (mixed), "
              f"{BENCH_R05_TPU['adjoint_bwd_fwd_ratio_seminorm']} (seminorm)", flush=True)
    return out


# --------------------------------------------------------------------------
# phase 8: the rest of D3STN (a reference checkpoint served, the training
# CLI) and the DDE extras (ddeint_adjoint through D3STN's field,
# ddeint_mos), and prefetch onto the card
# --------------------------------------------------------------------------

# ddeint_adjoint through D3STN (phase 8 c): one call of the field is a
# Predictor batch's forward without its lookup, one VJP of it a train step's
# backward without the lag gradient; the two lookups (y0 at the decoder
# lags, y_lags at the encoder lags) are one K1 launch and one lag-gradient
# launch each
FIELD_FWD = {**LAUNCHES_PER_BATCH, "spline": 0}
FIELD_BWD = {**{k: LAUNCHES_PER_STEP[k] - LAUNCHES_PER_BATCH[k] for k in _ZERO}, "spline_bwd": 0}
ADJOINT_LOOKUPS = {**_ZERO, "spline": 2, "spline_bwd": 2}


def adjoint_launches(evals, n_out=2):
    """The launches of one ddeint_adjoint forward + backward with a fixed
    solver of ``evals`` field calls over the span: the forward's, one call
    per later output for the t_span cotangent, and the backward's VJPs (a
    call and its backward each, on the forward's grid)."""
    return {k: ADJOINT_LOOKUPS[k] + (2 * evals + n_out - 1) * FIELD_FWD[k] + evals * FIELD_BWD[k]
            for k in _ZERO}


# ddeint_mos on MOS_BATCH trajectories (phase 8 d)
MOS_BATCH = 4096
# y' = -y(t - 1), phi == c, rk4 on a lag-aligned grid against the closed
# form, max |diff| over max |value| (the port's CPU solve: 1.7e-7 in
# float32, 3.3e-16 in float64)
MOS_CLOSED_TOL = {"float32": 2e-6, "float64": 1e-12}
# Mackey-Glass at tau = 2 on the card against the port's float64 solve on
# the CPU: the solution as above, each gradient relative (the CPU's float32
# solve: 3.0e-7; its lag gradient 9.6e-6, a sum with cancellation)
MOS_CPU_TOL = {"float32": 5e-6, "float64": 1e-12}
MOS_GRAD_TOL = {"float32": 1e-3, "float64": 1e-9}
# Mackey-Glass outputs and step (20 / 0.3 tiles as 67 steps of 0.2985: the
# lag of 2 falls between the knots, so its gradient is two-sided)
MG_T = (0.0, 20.0, 21)
MG_STEP = 0.3


def reference_state(np, cfg, rng):
    """A reference-format (PaddleXDE) D3STN state dict with random weights at
    ``cfg``'s shapes: every key that ``REFERENCE_KEY_RULES`` and the layer
    rules of ``convert_reference_state_dict`` name (the layout of
    tests/models/test_d3stn_golden.py's ``make_reference_state``)."""
    d, dp, ds = cfg.d_model, cfg.d_proj, cfg.d_sect

    def r(*shape):
        return (rng.randn(*shape) * 0.2).astype(np.float32)

    state = {
        "encoder_dense.weight": r(1, dp), "encoder_dense.bias": r(dp),
        "decoder_dense.weight": r(1, dp), "decoder_dense.bias": r(dp),
        "temporal_section_week.embedding.weight": r(7, ds),
        "temporal_section_day.embedding.weight": r(288, ds),
        "generator.weight": r(d, 1), "generator.bias": r(1),
        "encoder.norm.weight": 1.0 + r(d), "encoder.norm.bias": r(d),
        "decoder.norm.weight": 1.0 + r(d), "decoder.norm.bias": r(d),
    }
    if cfg.d_adaptive > 0:
        state["adaptive_embedding_encoder.embedding"] = r(cfg.num_nodes, cfg.tgt_len,
                                                          cfg.d_adaptive)
    stacks = (("encoder", cfg.encoder_num_layers, ("self_attn",), 2),
              ("decoder", cfg.decoder_num_layers, ("self_attn", "src_attn"), 3))
    for stack, n_layers, subs, n_norms in stacks:
        for i in range(n_layers):
            prefix = f"{stack}.layers.{i}"
            for s in subs:
                for c in ("query_conv", "key_conv", "value_conv", "out_conv"):
                    state[f"{prefix}.{s}.{c}.weight"] = r(d, d, 1, cfg.kernel_size)
                    state[f"{prefix}.{s}.{c}.bias"] = r(d)
            state[f"{prefix}.feed_forward_gcn.linear.weight"] = r(d, d)
            state[f"{prefix}.feed_forward_gcn.alpha"] = np.asarray([0.6], np.float32)
            state[f"{prefix}.feed_forward_gcn.beta"] = np.asarray([0.4], np.float32)
            for s in range(n_norms):
                state[f"{prefix}.sublayer.{s}.norm.weight"] = 1.0 + r(d)
                state[f"{prefix}.sublayer.{s}.norm.bias"] = r(d)
    return state


def nonzero(launches):
    return {k: v for k, v in launches.items() if v}


def serve_reference_checkpoint(torch, dev, config="PEMS08", batch=32):
    """(a) A reference-format checkpoint at ``config``'s shapes converted by
    ``convert_reference_state_dict`` (nothing unmatched; ``load_flax_params``
    raises unless the tree covers every parameter) and served: two batches
    through ``Predictor`` on the kernels, against the same weights through
    the plain versions on the card and the port's CPU forward (PREDICTOR_TOL).
    Returns the launches of the served batches."""
    import dataclasses

    import numpy as np

    from paddlexde_tpu_torch.models.d3stn import Predictor, convert_reference_state_dict, load_config
    from paddlexde_tpu_torch.ops import _build

    PlainPredictor = with_plain_history(Predictor)
    cfg = load_config(str(HERE / "examples" / "configs" / f"{config}.json"))
    plain_cfg = dataclasses.replace(cfg, attn_impl="xla", gcn_impl="xla")
    n, his = cfg.num_nodes, cfg.his_len
    rng = np.random.RandomState(0)
    state = reference_state(np, cfg, rng)
    params, unmatched = convert_reference_state_dict(state, cfg)
    require(unmatched == [], f"reference checkpoint: unmatched keys {unmatched}")
    a = rng.rand(n, n)
    sc = ((a + a.T) / 2).astype(np.float32)
    adj = (rng.rand(n, n) < 0.03).astype(np.float32)
    adj = np.maximum(adj, adj.T)
    enc = (np.arange(12) + rng.rand(12)).astype(np.float32)
    dec = (his - 1 - 1.5 * rng.rand(cfg.tgt_len)).astype(np.float32)
    pred = Predictor(cfg, params, enc, dec, adj, sc, batch_size=batch, device=dev)
    plain = PlainPredictor(plain_cfg, params, enc, dec, adj, sc, batch_size=batch, device=dev)
    cpu = PlainPredictor(plain_cfg, params, enc, dec, adj, sc, batch_size=batch, device="cpu")
    n_params = sum(p.numel() for p in pred.model.parameters())
    series = make_series(np, n, his + 2 * batch, seed=4)
    windows = np.stack([series[:, s : s + his] for s in range(2 * batch)])
    pred.warmup()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = pred(windows)
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    plain_out, cpu_out = plain(windows), cpu(windows[:batch])
    shape = (2 * batch, n, cfg.tgt_len)
    require(out.shape == shape and np.isfinite(out).all(),
            f"reference checkpoint served {out.shape}, expected {shape}, or non-finite values")
    err_plain = np.abs(out - plain_out).max() / np.abs(plain_out).max()
    err_cpu = np.abs(out[:batch] - cpu_out).max() / np.abs(cpu_out).max()
    print(f"  (a) a reference-format {config} checkpoint ({len(state)} arrays, {n_params} "
          f"parameters, seed 0) converted with nothing unmatched and served: {shape} in "
          f"{secs:.3f} s (host clock, 2 batches of {batch}); kernels vs plain versions on the "
          f"card {err_plain:.3e}, vs the CPU forward {err_cpu:.3e} (normalised max-abs, tol "
          f"{PREDICTOR_TOL:g}); launches {nonzero(launches)}", flush=True)
    require(err_plain <= PREDICTOR_TOL and err_cpu <= PREDICTOR_TOL,
            f"the served reference checkpoint disagrees: {err_plain:.3e} from the plain versions, "
            f"{err_cpu:.3e} from the CPU forward")
    want = {k: 2 * v for k, v in LAUNCHES_PER_BATCH.items()}
    require(launches == want, f"the served checkpoint launched {launches}, expected {want}")
    return launches


def train_cli(torch, dev):
    """(b) ``python -m paddlexde_tpu_torch.examples.train_d3stn --synthetic
    --train_epochs 1 --finetune_epochs 1`` through its ``main``: finite test
    metrics, the launches of K1-K5 equal to two epochs' steps and the eval
    and test batches (as ``train_phase``'s), each epoch's time from the
    Trainer's log. Returns the launches."""
    import re
    import shutil

    import numpy as np

    from paddlexde_tpu_torch.examples.train_d3stn import main as train_main
    from paddlexde_tpu_torch.examples.train_d3stn import parse_args, setup
    from paddlexde_tpu_torch.models.d3stn import TrafficFlowDataset
    from paddlexde_tpu_torch.ops import _build

    save_dir = HERE / "experiments" / "chip_smoke_cli"
    shutil.rmtree(save_dir, ignore_errors=True)
    argv = ["--synthetic", "--train_epochs", "1", "--finetune_epochs", "1",
            "--save_dir", str(save_dir)]
    cfg, data, _, _ = setup(parse_args(argv))
    splits = {k: TrafficFlowDataset(cfg, k, data=data) for k in ("train", "val", "test")}
    n_steps = sum(1 for _ in splits["train"].batch_starts(cfg.batch_size, drop_last=True))
    n_val = -(-len(splits["val"]) // cfg.batch_size)
    n_test = -(-len(splits["test"]) // cfg.batch_size)
    fwd_batches = 2 * n_val + n_test
    expected = {k: 2 * n_steps * LAUNCHES_PER_STEP[k] + fwd_batches * LAUNCHES_PER_BATCH[k]
                for k in LAUNCHES_PER_STEP}
    _build.reset_launches()
    t0 = time.perf_counter()
    results = train_main(argv)
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    log = next(save_dir.glob("*/*/log.txt")).read_text()
    epoch_s = [float(s) for s in re.findall(r"epoch: \d+, lr .*?, time ([\d.]+)s", log)]
    metrics = {k: results[k] for k in ("mae", "rmse", "mape", "smis")}
    print(f"  (b) the training CLI, {' '.join(argv)}: test {metrics}; epoch times (host clock) "
          f"{epoch_s} s, {secs:.1f} s in all with the Trainer's set-up, eval and test; "
          f"1 + 1 epochs of {n_steps} steps, {n_val} eval and {n_test} test batches; launches "
          f"{nonzero(launches)}", flush=True)
    require(len(epoch_s) == 2, f"the CLI's log holds {len(epoch_s)} epochs, expected 2")
    require(all(np.isfinite(v) for v in metrics.values()), f"the CLI's test metrics {metrics}")
    require(launches == expected, f"the CLI launched {launches}, expected {expected}")
    shutil.rmtree(save_dir, ignore_errors=True)
    return launches


def dde_adjoint_phase(torch, dev, config="PEMS08", batch=32):
    """(c) ``ddeint_adjoint`` through D3STN's field (``Predictor.forward``'s
    ``lambda y_lags, y: model(y_lags, y)``) at ``config``'s width and depth,
    ``his_processed=False``: the gradients of an MSE loss to every parameter
    and both lag sets on the kernels against the plain versions on the card
    (TRAIN_TOL per tensor), the lag gradients nonzero, with euler on [0, 1]
    (``cfg.solver``) and rk4 at step 0.25; K1's lag gradient, K3 and K5 in a
    profiler trace; the peak memory and time of forward + backward against
    ``ddeint`` with autograd (the adjoint's peak below at rk4) and the gap
    between the two gradients. Each checked call's launches must equal
    ``adjoint_launches``; returns their sum over the two solvers."""
    import dataclasses

    import numpy as np

    from paddlexde_tpu_torch import CubicHermiteSpline, ddeint, ddeint_adjoint, history_index
    from paddlexde_tpu_torch.models.d3stn import D3STN, load_config, norm_adj_matrix
    from paddlexde_tpu_torch.ops import _build

    cfg = load_config(str(HERE / "examples" / "configs" / f"{config}.json"))
    plain_cfg = dataclasses.replace(cfg, attn_impl="xla", gcn_impl="xla")
    n, his, tl = cfg.num_nodes, cfg.his_len, cfg.tgt_len
    rng = np.random.default_rng(5)
    a = rng.random((n, n))
    sc = norm_adj_matrix(((a + a.T) / 2).astype(np.float32)).astype(np.float32)
    adj = (rng.random((n, n)) < 0.03).astype(np.float32)
    adj = norm_adj_matrix(np.maximum(adj, adj.T)).astype(np.float32)
    model = D3STN(cfg, adj, sc, device=dev, generator=torch.Generator().manual_seed(0))
    plain = D3STN(plain_cfg, adj, sc, device=dev, generator=torch.Generator().manual_seed(0))
    plain.load_state_dict(model.state_dict())
    series = make_series(np, n, his + batch + tl, seed=5)
    win = torch.as_tensor(np.stack([series[:, s : s + his + tl] for s in range(batch)])).to(dev)
    src, tgt = win[:, :, :his].contiguous(), win[:, :, his:, :1].contiguous()
    his_span = torch.arange(his, dtype=torch.float32, device=dev)
    enc0 = (np.arange(his - 288, his - 276) + rng.random(12)).astype(np.float32)
    dec0 = (his - 1 - 1.5 * rng.random(tl)).astype(np.float32)
    t_span = torch.arange(2.0)
    names = [k for k, _ in model.named_parameters()] + ["enc_idx", "dec_idx"]

    def grads(m, solver, adjoint, interp="cubic"):
        enc = torch.tensor(enc0, device=dev, requires_grad=True)
        dec = torch.tensor(dec0, device=dev, requires_grad=True)
        y0 = history_index(dec, src, his_span, interpolation=interp)
        args = (lambda y_lags, y: m(y_lags, y), y0, t_span, enc, src, his_span, solver)
        kw = dict(options={"step_size": 0.25} if solver == "rk4" else None, time_axis=0,
                  interpolation=interp)
        if adjoint:
            sol, _ = ddeint_adjoint(*args, **kw, adjoint_params=tuple(m.parameters()))
        else:
            sol, _ = ddeint(*args, **kw)
        loss = ((sol[-1][..., :1] - tgt) ** 2).mean()
        # materialised as the Trainer does: PEMS08's gate (with_adj 0) leaves
        # the GCN's alpha out of the graph
        return loss.detach(), torch.autograd.grad(loss, [*m.parameters(), enc, dec],
                                                  materialize_grads=True)

    def peak_mb(fn):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        fn()
        torch.cuda.synchronize(dev)
        return torch.cuda.max_memory_allocated(dev) / 2**20

    launches, peaks = dict(_ZERO), {}
    for solver, evals in (("euler", 1), ("rk4", 4 * 4)):  # rk4: 4 steps of 4 stages
        _build.reset_launches()
        loss, got = grads(model, solver, True)
        torch.cuda.synchronize(dev)
        run = dict(_build.LAUNCHES)
        want_run = adjoint_launches(evals)
        loss_p, want = grads(plain, solver, True, CubicHermiteSpline)
        errs = grad_errors(names, got, want)
        worst = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
        loss_err = abs(loss.item() - loss_p.item()) / abs(loss_p.item())
        lag_g = [got[-2].abs().max().item(), got[-1].abs().max().item()]
        _, direct = grads(model, solver, False)
        gap = max(grad_errors(names, got, direct).values())
        peaks[solver] = (peak_mb(lambda: grads(model, solver, True)),
                         peak_mb(lambda: grads(model, solver, False)))
        adj_ms = host_clock_ms(torch, lambda: grads(model, solver, True), reps=3)
        dir_ms = host_clock_ms(torch, lambda: grads(model, solver, False), reps=3)
        print(f"  (c) ddeint_adjoint through D3STN ({config}, batch {batch}), {solver}"
              + (" step 0.25" if solver == "rk4" else "") + f" on [0, 1]: loss {loss.item():.6f}, "
              f"kernels vs plain versions on the card: loss {loss_err:.3e}, {len(errs)} gradient "
              f"tensors, max normalised err {worst[0][1]:.3e} (tol {TRAIN_TOL:g}; "
              + ", ".join(f"{k} {v:.2e}" for k, v in worst) + f"); max |lag gradient| enc "
              f"{lag_g[0]:.3e}, dec {lag_g[1]:.3e}; the adjoint's gradients vs direct autograd's "
              f"(no limit) {gap:.3e}; peak memory (max_memory_allocated) adjoint "
              f"{peaks[solver][0]:.0f} MiB, direct {peaks[solver][1]:.0f} MiB; forward + backward "
              f"(host clock, median of 3) adjoint {adj_ms:.2f} ms, direct {dir_ms:.2f} ms, ratio "
              f"{adj_ms / dir_ms:.2f}; launches of the checked call {nonzero(run)} ({evals} field "
              f"calls a pass)", flush=True)
        require(loss_err <= TRAIN_TOL and worst[0][1] <= TRAIN_TOL,
                f"ddeint_adjoint {solver}: the kernels' loss ({loss_err:.3e}) or gradient "
                f"{worst[0][0]} ({worst[0][1]:.3e}) differs from the plain versions'")
        require(all(g > 0 and math.isfinite(g) for g in lag_g),
                f"ddeint_adjoint {solver}: lag gradients {lag_g}")
        require(run == want_run, f"ddeint_adjoint {solver} launched {run}, expected {want_run}")
        launches = {k: launches[k] + run[k] for k in launches}
    require(peaks["rk4"][0] < peaks["rk4"][1],
            f"ddeint_adjoint rk4: peak {peaks['rk4'][0]:.0f} MiB, not below direct "
            f"autograd's {peaks['rk4'][1]:.0f} MiB")
    counts, device_us, _ = trace(torch, lambda: grads(model, "euler", True))
    seen = {k: sum(counts[k]) for k in ("spline_bwd", "gcn_bwd", "attn_bwd")}
    print(f"  profiler, ddeint_adjoint euler forward + backward: {seen} launches of K1's "
          f"lag gradient, K3 and K5, device time {device_us / 1e3:.3f} ms", flush=True)
    require(all(seen.values()), f"the adjoint backward's trace misses a kernel: {seen}")
    return launches


@contextlib.contextmanager
def device_syncs(torch):
    """The host-device synchronisations in the block (CUDA's sync debug
    mode, one warning each; the mode does not see every kind): ``where``
    holds the file:line of each after the block."""
    import warnings

    where = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield where
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the mode's own notice on being switched on ("a prototype feature and
    # does not yet detect all synchronizing operations") is not a sync
    where.extend(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                 if "called a synchronizing CUDA operation" in str(w.message))


def mos_closed(t):
    """y' = -y(t - 1), phi == 1: y(t) = sum (-1)^k (t - (k - 1))^k / k!
    (tests/functional/test_ddeint_mos.py:21-27)."""
    return sum((-1) ** k * max(t - (k - 1), 0.0) ** k / math.factorial(k)
               for k in range(int(math.floor(t)) + 2))


def mackey_glass(torch, dtype, device, kind, grad=False):
    """Mackey-Glass, y' = beta y(t - tau) / (1 + y(t - tau)^10) - 0.1 y at
    beta 0.2, tau 2 (non-chaotic), phi == c for MOS_BATCH values of c in
    [0.5, 1.5], by rk4: the lag a tensor, or (``kind`` "callable") the
    state-dependent 2 + 0.5 tanh(mean y - 1). Returns the solution and, with
    ``grad``, the gradients of mean y^2 to beta (and the tensor lag)."""
    import numpy as np

    from paddlexde_tpu_torch import ddeint_mos

    c = torch.linspace(0.5, 1.5, MOS_BATCH, dtype=dtype, device=device)
    his = c[:, None, None].expand(-1, 9, 1).contiguous()
    span = torch.linspace(-4.0, 0.0, 9, dtype=dtype, device=device)
    # made on the device (a fill, not a copy from the host: no sync)
    beta = torch.full((), 0.2, dtype=dtype, device=device, requires_grad=grad)
    tau = torch.full((1,), 2.0, dtype=dtype, device=device, requires_grad=grad)
    if kind == "tensor":
        lags = tau
    else:
        def lags(t, y):
            return torch.atleast_1d(2.0 + 0.5 * torch.tanh(y.mean() - 1.0))

    def field(t, y, y_lags):
        yl = y_lags[..., 0, :]
        return beta * yl / (1 + yl**10) - 0.1 * y

    sol = ddeint_mos(field, c[:, None], np.linspace(*MG_T), lags, his, span, solver="rk4",
                     step_size=MG_STEP, time_axis=0)
    if not grad:
        return sol, ()
    return sol, torch.autograd.grad((sol**2).mean(), [beta, tau] if kind == "tensor" else [beta])


def mos_phase(torch, dev):
    """(d) ``ddeint_mos`` on MOS_BATCH trajectories: the closed form of
    y' = -y(t - 1) in float32 and float64 (rk4 on a lag-aligned grid, exact
    to rounding); Mackey-Glass with a tensor and a callable lag against the
    port's float64 solve on the CPU, values and the gradients to the lag and
    a field parameter; host syncs per solve (at most one), launches per step
    and steps/s."""
    import numpy as np

    from paddlexde_tpu_torch import ddeint_mos
    from paddlexde_tpu_torch.ops.timing import device_profile

    cpu, f64 = torch.device("cpu"), torch.float64
    ts = np.linspace(0.0, 3.0, 13)
    truth = torch.tensor([mos_closed(t) for t in ts], dtype=f64)
    for dtype in (torch.float32, f64):
        key = str(dtype).split(".")[-1]
        c = torch.linspace(0.5, 2.0, MOS_BATCH, dtype=dtype, device=dev)
        his = c[:, None, None].expand(-1, 9, 1).contiguous()
        span = torch.linspace(-2.0, 0.0, 9, dtype=dtype, device=dev)
        lag = torch.full((1,), 1.0, dtype=dtype, device=dev)

        def solve():
            return ddeint_mos(lambda t, y, y_lags: -y_lags[..., 0, :], c[:, None], ts, lag, his,
                              span, solver="rk4", step_size=0.25, time_axis=0)

        with device_syncs(torch) as syncs:
            sol = solve()
        want = truth[:, None] * c.double().cpu()[None]
        err = norm_err(sol[..., 0].double().cpu(), want)
        print(f"  (d) ddeint_mos, y' = -y(t - 1), phi == c for {MOS_BATCH} values of c, rk4 step "
              f"0.25 on [0, 3], {key} on the card: {err:.3e} of the scale from c times the closed "
              f"form (limit {MOS_CLOSED_TOL[key]:g}); {len(syncs)} host syncs in the solve {syncs}",
              flush=True)
        require(sol.shape == (13, MOS_BATCH, 1) and err <= MOS_CLOSED_TOL[key],
                f"ddeint_mos {key}: shape {tuple(sol.shape)}, {err:.3e} from the closed form")
        require(len(syncs) <= 1, f"ddeint_mos {key}: host syncs in one solve at {syncs}")
    for kind in ("tensor", "callable"):
        ref, ref_g = mackey_glass(torch, f64, cpu, kind, grad=True)
        for dtype in (torch.float32, f64):
            key = str(dtype).split(".")[-1]
            sol, g = mackey_glass(torch, dtype, dev, kind, grad=True)
            err = norm_err(sol.double().cpu(), ref)
            g_err = [abs(a.item() - b.item()) / abs(b.item()) for a, b in zip(g, ref_g)]
            print(f"  (d) Mackey-Glass (tau 2, beta 0.2, {MOS_BATCH} histories), {kind} lag, "
                  f"rk4 step {MG_STEP} on [0, 20], {key} on the card against the CPU's float64 "
                  f"solve: values {err:.3e} (limit {MOS_CPU_TOL[key]:g}); gradients of mean y^2 "
                  f"to beta" + (" and the lag" if kind == "tensor" else "") + " "
                  + ", ".join(f"{a.item():.6e}" for a in g) + f", relative errors "
                  + ", ".join(f"{e:.2e}" for e in g_err) + f" (limit {MOS_GRAD_TOL[key]:g})",
                  flush=True)
            require(bool(torch.isfinite(sol).all()) and err <= MOS_CPU_TOL[key],
                    f"Mackey-Glass {kind} {key}: {err:.3e} from the CPU float64 solve")
            require(all(e <= MOS_GRAD_TOL[key] for e in g_err),
                    f"Mackey-Glass {kind} {key}: gradient errors {g_err}")
    n_steps = math.ceil((MG_T[1] - MG_T[0]) / MG_STEP - 1e-9)

    def solve():
        mackey_glass(torch, torch.float32, dev, "tensor")

    with device_syncs(torch) as syncs:
        solve()
    host_ms = host_clock_ms(torch, solve, reps=3)
    device_ms, per_solve, _ = device_profile(solve, reps=1, traces=1)
    print(f"  (d) Mackey-Glass float32, tensor lag, {n_steps} rk4 steps a solve: host clock "
          f"{host_ms:.2f} ms ({n_steps / host_ms * 1e3:.0f} steps/s), device time "
          f"{device_ms:.3f} ms (idle share {1 - device_ms / host_ms:.1%}), "
          f"{per_solve / n_steps:.1f} kernel launches a step, {len(syncs)} host syncs a solve; "
          f"card {card_line()}", flush=True)
    require(len(syncs) <= 1, f"ddeint_mos: host syncs in one solve at {syncs}")


def prefetch_check(torch, dev):
    """(e) ``prefetch`` onto the card from one pinned host buffer that the
    generator refills: every item equals the snapshot taken when it was
    produced; an early close leaves no producer thread."""
    import threading

    from paddlexde_tpu_torch.utils import prefetch

    buf = torch.empty((1024, 1024), pin_memory=True)
    gen = torch.Generator().manual_seed(0)
    snaps = []

    def batches(count):
        for _ in range(count):
            buf.uniform_(generator=gen)
            snaps.append(buf.clone())
            yield {"x": buf}

    got = [item["x"] for item in prefetch(batches(16), depth=2, device=dev)]
    same = [x.device == dev and torch.equal(x.cpu(), s) for x, s in zip(got, snaps)]
    before = threading.active_count()
    it = prefetch(batches(10**6), depth=2, device=dev)
    next(it)
    it.close()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    print(f"  (e) prefetch, 16 refills of one pinned 4 MiB host "
          f"buffer onto {dev}: {sum(same)} of {len(got)} items equal their snapshots; after an "
          f"early close {threading.active_count()} threads ({before} before)", flush=True)
    require(len(got) == 16 and all(same), "prefetch: an item differs from its snapshot")
    require(threading.active_count() <= before, "prefetch: the producer outlived an early close")


def dde_extras_phase(torch, dev, config="PEMS08", batch=32):
    """Phase 8 (module docstring). Returns the launches of (a), (b) and (c)."""
    card = card_line()
    print("phase 8: a reference checkpoint served, the training CLI, ddeint_adjoint through "
          f"D3STN, ddeint_mos, prefetch; every figure below on {card}", flush=True)
    served = serve_reference_checkpoint(torch, dev, config, batch)
    cli = train_cli(torch, dev)
    dde = dde_adjoint_phase(torch, dev, config, batch)
    mos_phase(torch, dev)
    prefetch_check(torch, dev)
    total = {k: served[k] + cli[k] + dde[k] for k in served}
    print(f"phase 8 launches by kernel: {nonzero(total)}", flush=True)
    return served, cli, dde


# --------------------------------------------------------------------------
# phase 9: the rest of the ODE solver zoo (no kernel of its own): the JAX
# package's stiff, event, Hamiltonian, multistep, per-element and CNF
# workloads at full size in float32 on the card, each against the port's
# float64 solve on the CPU (the CPU tests tie that solve to the JAX package)
# --------------------------------------------------------------------------

# the limits, each from the port's float32 solve on the CPU against the same
# float64 reference (its measure in the comment): Robertson, max over the
# three species of max |diff| / max |reference|, against an LSODA solve at
# rtol 1e-10 (sdirk2 on the demo's 40-point grid 4.2e-3; kvaerno3 7.4e-5,
# sdirk4 1.6e-4, trbdf2 5.5e-4; LSODA from a float64 card state 7.1e-6)
ROBERTSON = {"sdirk2": ({}, 1e-2), "kvaerno3": ({"rtol": 1e-4, "atol": 1e-8}, 1e-3),
             "sdirk4": ({"rtol": 3e-5, "atol": 1e-8}, 1e-3),
             "trbdf2": ({"rtol": 1e-4, "atol": 1e-8}, 5e-3),
             "scipy_solver": ({"rtol": 1e-6, "atol": 1e-10}, 1e-4)}
# the demo's own limit on the drift of y1 + y2 + y3 (sdirk4 in float32 at
# rtol 3e-5 on the CPU: 5.3e-6; at rtol 1e-5 it rounds past 1e-5, 1.3e-5)
MASS_TOL = 1e-5
# odeint_adjoint with kvaerno3 against direct autograd, both on the card in
# float64 (the gradient of Robertson's species to its log rate constants
# over [0, 1e-3] at rtol 1e-5): the two are O(rtol) approximations of the
# same derivative (1.3e-5 apart on the CPU)
ROBERTSON_ADJ_TOL = 1e-3
# the bouncing ball's event time and dt*/dh0 against their closed forms
# (the JAX demo's limit)
EVENT_TOL = 1e-4
# the rest against the CPU's float64 solve of the same problem (their CPU
# float32 measures: Fisher-KPP D = 256 2.4e-7; the Adams solves on the
# spiral 6.3e-6 and 7.1e-6; the CNF 2.2e-7; the per-element solve 2.9e-5 of
# the closed form; the dopri5 tangent 2.3e-7 from a central difference in
# float64), and the preconditioned Newton residual of the D = 8191 front
ZOO_TOL = {"kpp256": 1e-5, "kpp_newton": 1e-4, "adams": 1e-4, "cnf": 1e-4, "per_element": 1e-4,
           "jvp": 1e-4}
KPP = {"nu": 1e-3, "t1": 4.0, "outputs": 9}
PENDULUM = {"q0": 1.5, "h": 0.25, "steps": 10_000}
PER_ELEMENT = {"batch": 4096, "rtol": 1e-5, "atol": 1e-8}
CNF = {"samples": 2048, "width": 64, "grid": 16}


def robertson_field(torch, k=None):
    def f(t, y):
        k1, k2, k3 = (0.04, 1.0e4, 3.0e7) if k is None else (k[0], k[1], k[2])
        r1, r2, r3 = k1 * y[0], k2 * y[1] * y[2], k3 * y[1] * y[1]
        return torch.stack([-r1 + r2, r1 - r2 - r3, r3])

    return f


def kpp_field(torch, d, nu):
    dx = 1.0 / (d + 1)

    def f(t, u):
        up = torch.nn.functional.pad(u, (1, 1))
        return nu * (up[2:] - 2.0 * up[1:-1] + up[:-2]) / dx**2 + u * (1.0 - u)

    return f


def kpp_problem(torch, d, dtype, device):
    dx = 1.0 / (d + 1)
    x = torch.arange(1, d + 1, dtype=dtype, device=device) * dx
    t = torch.linspace(0.0, KPP["t1"], KPP["outputs"], dtype=dtype, device=device)
    return torch.exp(-200.0 * (x - 0.2) ** 2), t, dx


def species_err(got, want):
    return max(norm_err(got[..., i].double().cpu(), want[..., i].double()) for i in range(3))


def zoo_run(torch, dev, fn, steps=None, profile=True):
    """Run ``fn`` once and measure that run: ``(out, figures)`` with the
    host clock, the host-device synchronisations (CUDA's sync debug mode,
    with the lines that made them), the engine's host reads and, with
    ``profile``, the device time and CUDA launches from a ``torch.profiler``
    trace of the same run (so the host clock includes the profiler's own
    cost, a few µs a launch), the idle share and, given ``steps``, launches
    and steps per second."""
    from collections import Counter

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler

    from paddlexde_tpu_torch.solver import adaptive

    cuda = dev.type == "cuda"
    trace = profiler(activities=[ProfilerActivity.CUDA]) if cuda and profile else None
    adaptive.reset_host_reads()
    if cuda:
        torch.cuda.synchronize()
    with (device_syncs(torch) if cuda else contextlib.nullcontext([])) as where, (
            trace if trace is not None else contextlib.nullcontext()):
        start = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        wall = (time.perf_counter() - start) * 1e3
    fig = {"wall_ms": wall, "syncs": len(where), "sync_lines": Counter(where).most_common(3),
           "reads": dict(adaptive.HOST_READS)}
    if trace is not None:
        events = [e for e in trace.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        device_ms = sum(e.device_time for e in events) / 1e3
        fig.update(device_ms=device_ms, launches=len(events), idle=1.0 - device_ms / wall)
        if steps:
            fig["launches_per_step"] = len(events) / steps
    if steps:
        fig.update(steps=steps, steps_per_s=steps / (wall / 1e3))
    return out, fig


def zoo_sliced(torch, dev, fig, fn, steps, total):
    """Launches a step, device time and idle share of a long run from a
    profiled run of its first ``steps`` steps (``fn`` runs them), scaled to
    its ``total`` steps: a trace of ~10^5-10^6 launches costs more than the
    run it measures."""
    _, short = zoo_run(torch, dev, fn, steps=steps)
    if "idle" in short:
        fig.update(launches_per_step=short["launches_per_step"], idle=short["idle"],
                   device_ms=short["device_ms"] * total / steps,
                   launches=short["launches"] * total / steps)
    return fig


def zoo_line(label, fig, extra=""):
    parts = [f"{fig['wall_ms']:.1f} ms host clock"]
    if "steps" in fig:
        parts.append(f"{fig['steps']} steps, {fig['steps_per_s']:.0f} steps/s")
    if "device_ms" in fig:
        parts.append(f"device {fig['device_ms']:.2f} ms in {fig['launches']:.0f} launches"
                     + (f" ({fig['launches_per_step']:.0f} a step)" if "launches_per_step" in fig
                        else "") + f", idle share {fig['idle']:.1%}")
    reads = fig["reads"]
    attempted = fig.get("attempted")
    parts.append(f"{fig['syncs']} host syncs {fig['sync_lines']}" + (
        f", {reads['step']} engine reads for {attempted} attempted steps "
        f"({reads['step'] / max(attempted, 1):.2f} a step) + {reads['setup']} setup"
        if attempted is not None else ""))
    print(f"  {label}: {extra}; " + "; ".join(parts), flush=True)


def robertson_runs(torch, dev):
    """(a) Robertson on the demo's grid: sdirk2, kvaerno3, sdirk4, trbdf2,
    LSODA from a card state; the kvaerno3 adjoint gradient."""
    import numpy as np

    from paddlexde_tpu_torch import odeint, odeint_adjoint

    f64, cpu = torch.float64, torch.device("cpu")
    ts_np = np.concatenate([np.zeros(1), np.logspace(-5, 2, 40)])
    ref = odeint(robertson_field(torch), torch.tensor([1.0, 0.0, 0.0], dtype=f64),
                 torch.tensor(ts_np), "scipy_solver", rtol=1e-10, atol=1e-14, time_axis=0)
    out = {}
    for name, (kw, tol) in ROBERTSON.items():
        dtype = f64 if name == "scipy_solver" else torch.float32
        y0 = torch.zeros(3, dtype=dtype, device=dev)
        y0[0] = 1.0
        t = torch.cat([torch.zeros(1, dtype=dtype, device=dev),
                       torch.logspace(-5, 2, 40, dtype=dtype, device=dev)])
        adaptive = name in ("kvaerno3", "sdirk4", "trbdf2")
        opts = {"return_stats": True} if adaptive else None

        def solve(name=name, kw=kw, y0=y0, t=t, opts=opts):
            return odeint(robertson_field(torch), y0, t, name, time_axis=0, options=opts, **kw)

        res, fig = zoo_run(torch, dev, solve, profile=name != "scipy_solver")
        sol, stats = res if adaptive else (res, None)
        require(sol.shape == (41, 3) and bool(torch.isfinite(sol).all()),
                f"Robertson {name}: shape {tuple(sol.shape)} or non-finite values")
        drift = (sol.double().sum(-1) - 1.0).abs().max().item()
        err = species_err(sol, ref)
        require(drift < MASS_TOL, f"Robertson {name}: mass drift {drift:.3e}, limit {MASS_TOL}")
        require(err <= tol, f"Robertson {name}: {err:.3e} from the CPU's LSODA at rtol 1e-10, "
                f"limit {tol}")
        if adaptive:
            require(stats.status == 0, f"Robertson {name}: status {stats.status}")
            fig["attempted"] = stats.n_accept + stats.n_reject
            require(fig["reads"]["step"] == fig["attempted"],
                    f"Robertson {name}: {fig['reads']} host reads for {fig['attempted']} steps")
            fig.update(steps=fig["attempted"],
                       steps_per_s=fig["attempted"] / (fig["wall_ms"] / 1e3))
            if "launches" in fig:
                fig["launches_per_step"] = fig["launches"] / fig["attempted"]
        elif name == "sdirk2":
            fig.update(steps=40, steps_per_s=40 / (fig["wall_ms"] / 1e3))
            if "launches" in fig:
                fig["launches_per_step"] = fig["launches"] / 40
        zoo_line(f"Robertson {name}", fig,
                 f"{'float64 card state, ' if name == 'scipy_solver' else ''}mass drift "
                 f"{drift:.2e} (limit {MASS_TOL}), {err:.2e} from LSODA at rtol 1e-10 (limit "
                 f"{tol})" + (f", stats {tuple(stats)}" if stats else ""))
        out[name] = fig

    # the kvaerno3 adjoint against direct autograd (float64 on the card)
    grads = []
    for adjoint in (False, True):
        k = torch.tensor([0.04, 1.0e4, 3.0e7], dtype=f64, device=dev, requires_grad=True)
        y0 = torch.zeros(3, dtype=f64, device=dev)
        y0[0] = 1.0
        t = torch.linspace(0.0, 1e-3, 2, dtype=f64, device=dev)
        kw = {"adjoint_params": (k,)} if adjoint else {}
        solve = odeint_adjoint if adjoint else odeint
        start = time.perf_counter()
        ys = solve(robertson_field(torch, k), y0, t, "kvaerno3", rtol=1e-5, atol=1e-9,
                   time_axis=0, **kw)
        (g,) = torch.autograd.grad(ys[-1][1] * 1e4 + ys[-1][2], k)
        grads.append((g * k.detach()).cpu())
        out["adjoint_ms" if adjoint else "direct_ms"] = (time.perf_counter() - start) * 1e3
    err = norm_err(grads[1], grads[0])
    require(bool(torch.isfinite(grads[1]).all()) and err <= ROBERTSON_ADJ_TOL,
            f"Robertson kvaerno3 adjoint gradient {grads[1].tolist()} is {err:.3e} from direct "
            f"autograd {grads[0].tolist()}, limit {ROBERTSON_ADJ_TOL}")
    print(f"  Robertson kvaerno3 gradient to log k over [0, 1e-3] (float64): odeint_adjoint "
          f"{err:.2e} from direct autograd (limit {ROBERTSON_ADJ_TOL}); forward + backward "
          f"{out['adjoint_ms']:.0f} ms adjoint, {out['direct_ms']:.0f} ms direct", flush=True)
    return out


def kpp_runs(torch, dev):
    """(b) Fisher-KPP fronts: D = 256 unpreconditioned implicit Euler
    Newton-Krylov against the CPU; D = 8191 preconditioned, implicit Euler
    and SDIRK2."""
    from paddlexde_tpu_torch import odeint
    from paddlexde_tpu_torch.solver.implicit import (
        make_implicit_euler_krylov_step,
        make_sdirk2_step,
    )
    from paddlexde_tpu_torch.utils.preconditioners import dirichlet_heat_preconditioner

    nu = KPP["nu"]
    u0_64, t64, _ = kpp_problem(torch, 256, torch.float64, torch.device("cpu"))
    ref = odeint(kpp_field(torch, 256, nu), u0_64, t64, "implicit_euler_krylov", time_axis=0)
    u0, t, _ = kpp_problem(torch, 256, torch.float32, dev)
    sol, fig = zoo_run(torch, dev, lambda: odeint(kpp_field(torch, 256, nu), u0, t,
                                                  "implicit_euler_krylov", time_axis=0),
                       steps=KPP["outputs"] - 1, profile=False)
    zoo_sliced(torch, dev, fig, lambda: odeint(kpp_field(torch, 256, nu), u0, t[:2],
                                               "implicit_euler_krylov", time_axis=0),
               1, KPP["outputs"] - 1)
    cover = (sol > 0.5).float().mean(-1)
    err = norm_err(sol.double().cpu(), ref)
    require(bool(torch.isfinite(sol).all()) and cover[-1] > cover[0] and err <= ZOO_TOL["kpp256"],
            f"Fisher-KPP D=256: coverage {cover.tolist()}, {err:.3e} from the CPU's float64 solve "
            f"(limit {ZOO_TOL['kpp256']})")
    zoo_line("Fisher-KPP D=256 implicit_euler_krylov (device time, launches and idle share of "
             "the first step, scaled)", fig,
             f"front coverage {[round(c, 3) for c in cover.tolist()]}, {err:.2e} from the CPU's "
             f"float64 solve (limit {ZOO_TOL['kpp256']})")
    out = {"kpp256": fig}

    d = 8191
    u0, t, dx = kpp_problem(torch, d, torch.float32, dev)
    dt = KPP["t1"] / (KPP["outputs"] - 1)
    f = kpp_field(torch, d, nu)
    g = 1.0 - 0.5 * 2.0**0.5  # SDIRK2's gamma: its stage operator is I - g dt J
    # implicit Euler on the demo's 8 steps of 0.5; SDIRK2 on 4 steps of 1.0
    # (its two stages double the implicit solves, and the host clock sets
    # the phase's time); each preconditioner inverts its stage operator,
    # I - dt J and I - g dt J
    steps = {
        "implicit_euler_krylov": (make_implicit_euler_krylov_step(
            preconditioner=dirichlet_heat_preconditioner(d, dx, dt, nu=nu)), t),
        "sdirk2_krylov": (make_sdirk2_step(krylov=True, preconditioner=(
            dirichlet_heat_preconditioner(d, dx, g * 2 * dt, nu=nu))), t[::2]),
    }
    # the Newton residual of the last implicit Euler step, u1 - u0 - dt f(u1),
    # in float64 on the CPU and mapped back to the state's units by the
    # preconditioner (the correction a further Newton iteration would make;
    # unmapped, the float32 rounding of u times dt nu 4/dx^2 ~ 1e5 hides it)
    f64 = kpp_field(torch, d, nu)
    m64 = dirichlet_heat_preconditioner(d, dx, dt, nu=nu, dtype=torch.float64)
    for name, (step, tt) in steps.items():
        sol, fig = zoo_run(torch, dev, lambda step=step, tt=tt: odeint(f, u0, tt, step,
                                                                       time_axis=0),
                           steps=tt.shape[0] - 1, profile=False)
        zoo_sliced(torch, dev, fig, lambda step=step, tt=tt: odeint(f, u0, tt[:2], step,
                                                                    time_axis=0),
                   1, tt.shape[0] - 1)
        cover = (sol > 0.5).float().mean(-1)
        require(bool(torch.isfinite(sol).all()) and cover[-1] > cover[0],
                f"Fisher-KPP D={d} {name} (preconditioned): finite "
                f"{bool(torch.isfinite(sol).all())}, coverage {cover.tolist()}")
        extra = ""
        if name == "implicit_euler_krylov":
            u1, u0_ = sol[-1].double().cpu(), sol[-2].double().cpu()
            resid = m64(u1 - u0_ - dt * f64(t[-1].double().cpu(), u1)).abs().max().item() / \
                u1.abs().max().item()
            require(resid <= ZOO_TOL["kpp_newton"], f"Fisher-KPP D={d}: the last step's "
                    f"preconditioned Newton residual {resid:.3e}, limit {ZOO_TOL['kpp_newton']}")
            extra = (f", the last step's Newton residual (preconditioned, float64) {resid:.2e} of "
                     f"max |u| (limit {ZOO_TOL['kpp_newton']})")
            fig["residual"] = resid
        zoo_line(f"Fisher-KPP D={d} {name}, Dirichlet heat preconditioner (device time, "
                 f"launches and idle share of the first step, scaled)", fig,
                 f"front coverage {[round(c, 3) for c in cover.tolist()]}{extra}")
        out[name] = dict(fig, coverage=cover.tolist())
    return out


def event_runs(torch, dev):
    """(c) The bouncing ball: t* and dt*/dh0 against the closed forms."""
    import numpy as np

    from paddlexde_tpu_torch import odeint_event, odeint_event_grad

    g, h0 = 9.81, 10.0

    def f(t, y):
        return torch.stack([y[1], -g * torch.ones_like(y[0])])

    def ground(t, y):
        return y[0]

    y0 = torch.zeros(2, device=dev)
    y0[0] = h0
    res, fig = zoo_run(torch, dev, lambda: odeint_event(f, y0, 0.0, ground, "dopri5", t_max=10.0))
    t_star = res.t_event.item()
    closed = float(np.sqrt(2 * h0 / g))
    h = torch.full((), h0, device=dev, requires_grad=True)
    r = odeint_event_grad(f, torch.stack([h, torch.zeros((), device=dev)]), 0.0, ground, "dopri5",
                          t_max=10.0)
    (dt_dh,) = torch.autograd.grad(r.t_event, h)
    closed_grad = 1.0 / np.sqrt(2.0 * g * h0)
    require(res.event_fired and abs(t_star - closed) <= EVENT_TOL
            and abs(dt_dh.item() - closed_grad) <= EVENT_TOL,
            f"bouncing ball: t* {t_star} (closed form {closed}), dt*/dh0 {dt_dh.item()} (closed "
            f"form {closed_grad}), limit {EVENT_TOL}")
    fig["attempted"] = fig["reads"]["step"]
    zoo_line("bouncing ball, odeint_event dopri5 (float32)", fig,
             f"t* {t_star:.7f} vs {closed:.7f}, dt*/dh0 {dt_dh.item():.7f} vs {closed_grad:.7f} "
             f"(limit {EVENT_TOL}); the sign test rides in the step's read")
    return {"event": fig}


def pendulum_and_adams_runs(torch, dev):
    """(d) yoshida4, leapfrog and rk4 on the pendulum over 1e4 steps; the
    Adams solvers on bench.py's spiral."""
    from paddlexde_tpu_torch import odeint

    def field(t, y):
        return y[1], -torch.sin(y[0])

    steps, h = PENDULUM["steps"], PENDULUM["h"]
    t = torch.linspace(0.0, steps * h, steps + 1, device=dev)
    q0 = torch.full((1,), PENDULUM["q0"], device=dev)
    drift, out = {}, {}
    for name in ("yoshida4", "leapfrog", "rk4"):
        (q, p), fig = zoo_run(torch, dev, lambda name=name: odeint(
            field, (q0, torch.zeros_like(q0)), t, name, time_axis=0), steps=steps, profile=False)
        zoo_sliced(torch, dev, fig, lambda name=name: odeint(
            field, (q0, torch.zeros_like(q0)), t[:201], name, time_axis=0), 200, steps)
        energy = (0.5 * p.double() ** 2 + 1.0 - torch.cos(q.double()))[:, 0]
        err = (energy - energy[0]).abs()
        half = steps // 2
        drift[name] = (err[:half].max().item(), err[half:].max().item(), err[-1].item())
        zoo_line(f"pendulum {name} (device time, launches and idle share of 200 steps, "
                 f"scaled)", fig, f"|H - H0| max over the first half "
                 f"{drift[name][0]:.2e}, over the second {drift[name][1]:.2e}, at t = "
                 f"{steps * h:.0f} {drift[name][2]:.2e}")
        out[name] = fig
    y4, rk = drift["yoshida4"], drift["rk4"]
    require(y4[1] <= 2.0 * y4[0] and rk[1] > 1.5 * rk[0] and rk[2] > 5 * y4[1],
            f"pendulum energy: yoshida4 {y4}, rk4 {rk} (first-half max, second-half max, end): "
            "yoshida4's must stay bounded and rk4's grow past it")

    p32, _ = spiral_problem(torch, torch.float32, dev)
    p64, _ = spiral_problem(torch, torch.float64, torch.device("cpu"))
    for name in ("adams", "implicit_adams"):
        def solve(p, dtype, device, name=name):
            y0 = torch.full((1, 2), 0.0, dtype=dtype, device=device)
            y0[0, 0] = 2.0
            tt = torch.linspace(0.0, SPIRAL["t1"], SPIRAL["n_points"], dtype=dtype, device=device)
            return odeint(spiral_field(torch, p), y0, tt, name, time_axis=0)

        ref = solve(p64, torch.float64, torch.device("cpu"))
        sol, fig = zoo_run(torch, dev, lambda: solve(p32, torch.float32, dev),
                           steps=SPIRAL["n_points"] - 1)
        err = norm_err(sol.double().cpu(), ref)
        require(bool(torch.isfinite(sol).all()) and err <= ZOO_TOL["adams"],
                f"spiral {name}: {err:.3e} from the CPU's float64 solve, limit {ZOO_TOL['adams']}")
        zoo_line(f"spiral {name} (bench.py's field, 999 steps of 0.025)", fig,
                 f"{err:.2e} from the CPU's float64 solve (limit {ZOO_TOL['adams']})")
        out[name] = fig
    return out


def per_element_cnf_jvp_runs(torch, dev):
    """(e) odeint_per_element on 4096 elements of y' = -y^2 with y0 in
    [1, 160]; the exact-divergence CNF over 2048 samples with rk4;
    torch.func.jvp through a dopri5 spiral solve against a central
    difference."""
    import numpy as np

    from paddlexde_tpu_torch import odeint, odeint_per_element
    from paddlexde_tpu_torch.utils.divergence import cnf_aug_dynamics

    n = PER_ELEMENT["batch"]
    y0 = torch.linspace(1.0, 160.0, n, device=dev)[:, None]
    t = torch.linspace(0.0, 1.0, 5, device=dev)
    (sol, stats), fig = zoo_run(torch, dev, lambda: odeint_per_element(
        lambda t, y: -y * y, y0, t, "dopri5", rtol=PER_ELEMENT["rtol"],
        atol=PER_ELEMENT["atol"], options={"return_stats": True}, time_axis=0))
    exact = (y0[:, None, :] / (1.0 + y0[:, None, :] * t[None, :, None])).double()
    err = ((sol.double() - exact).abs() / exact.abs()).max().item()
    nfe = stats.nfe.cpu()
    # an attempted step of the batched controller: one iteration, in which
    # every element still short of the current output attempts one step
    most = int((stats.n_accept + stats.n_reject).max())
    iterations = fig["reads"]["step"]
    fig.update(attempted=iterations, steps=iterations,
               steps_per_s=iterations / (fig["wall_ms"] / 1e3))
    if "launches" in fig:
        fig["launches_per_step"] = fig["launches"] / iterations
    # one read a controller step (the engine's counter), and no other sync
    # but the span's read and at most one an output evaluation
    syncs_ok = dev.type != "cuda" or fig["syncs"] <= iterations + fig["reads"]["setup"] + 4
    require(bool((stats.status == 0).all()) and err <= ZOO_TOL["per_element"]
            and most <= iterations and syncs_ok and int(nfe.max()) > int(nfe.min()) + 10
            and fig["reads"]["step"] == iterations,
            f"odeint_per_element: error {err:.3e} (limit {ZOO_TOL['per_element']}), nfe "
            f"{int(nfe.min())}..{int(nfe.max())}, {fig['reads']} reads and {fig['syncs']} syncs "
            f"for {iterations} iterations (an element's most attempts {most})")
    zoo_line(f"odeint_per_element dopri5, {n} elements y' = -y^2, y0 in [1, 160]", fig,
             f"an element's attempts at most {most}, per-element nfe {int(nfe.min())}.."
             f"{int(nfe.max())} (median "
             f"{int(nfe.median())}), max relative error {err:.2e} against y0/(1 + y0 t) (limit "
             f"{ZOO_TOL['per_element']})")
    out = {"per_element": dict(fig, nfe=(int(nfe.min()), int(nfe.max())))}

    rng = np.random.RandomState(0)
    w = CNF["width"]
    raw = {"w1": rng.randn(3, w) * np.sqrt(2.0 / (3 + w)), "b1": np.zeros(w),
           "w2": rng.randn(w, w) * np.sqrt(1.0 / w), "b2": np.zeros(w),
           "w3": rng.randn(w, 2) * np.sqrt(2.0 / (w + 2)) * 0.01, "b3": np.zeros(2)}
    z_np = rng.randn(CNF["samples"], 2)

    def cnf_solve(dtype, device):
        p = {k: torch.tensor(v, dtype=dtype, device=device) for k, v in raw.items()}

        def f(t, z):
            h = torch.cat([z, t.expand(z.shape[:-1] + (1,)).to(z.dtype)], -1)
            h = torch.tanh(h @ p["w1"] + p["b1"])
            h = torch.tanh(h @ p["w2"] + p["b2"])
            return h @ p["w3"] + p["b3"]

        z = torch.tensor(z_np, dtype=dtype, device=device)
        grid = torch.linspace(0.0, 1.0, CNF["grid"] + 1, dtype=dtype, device=device)
        return odeint(cnf_aug_dynamics(f, "exact"), (z, torch.zeros(z.shape[0], dtype=dtype,
                                                                     device=device)),
                      grid[[0, -1]], "rk4", options={"grid": grid}, time_axis=0)

    ref = cnf_solve(torch.float64, torch.device("cpu"))
    (zs, lp), fig = zoo_run(torch, dev, lambda: cnf_solve(torch.float32, dev), steps=CNF["grid"])
    err = max(norm_err(zs.double().cpu(), ref[0]), norm_err(lp.double().cpu(), ref[1]))
    require(bool(torch.isfinite(zs).all() and torch.isfinite(lp).all()) and err <= ZOO_TOL["cnf"],
            f"CNF: {err:.3e} from the CPU's float64 solve, limit {ZOO_TOL['cnf']}")
    zoo_line(f"CNF exact divergence, {CNF['samples']} samples, width {w}, rk4 on "
             f"{CNF['grid']} steps", fig, f"{err:.2e} from the CPU's float64 solve (limit "
             f"{ZOO_TOL['cnf']}), mean log-density change {lp[-1].mean().item():.4f}")
    out["cnf"] = fig

    # torch.func.jvp through dopri5 against a central difference (float64)
    p64, _ = spiral_problem(torch, torch.float64, dev)
    tt = torch.linspace(0.0, 5.0, 50, dtype=torch.float64, device=dev)

    def spiral(y):
        return odeint(spiral_field(torch, p64), y, tt, "dopri5", rtol=1e-10, atol=1e-12,
                      time_axis=0)

    y0 = torch.zeros(1, 2, dtype=torch.float64, device=dev)
    y0[0, 0] = 2.0
    v = torch.zeros_like(y0)
    v[0, 0], v[0, 1] = 0.6, -0.8
    eps = 1e-5
    start = time.perf_counter()
    _, tangent = torch.func.jvp(spiral, (y0,), (v,))
    jvp_ms = (time.perf_counter() - start) * 1e3
    fd = (spiral(y0 + eps * v) - spiral(y0 - eps * v)) / (2 * eps)
    err = norm_err(tangent.cpu(), fd.cpu())
    require(err <= ZOO_TOL["jvp"], f"torch.func.jvp through dopri5: {err:.3e} from the central "
            f"difference, limit {ZOO_TOL['jvp']}")
    print(f"  torch.func.jvp of a dopri5 spiral solve (float64, rtol 1e-10, t in [0, 5]): "
          f"{err:.2e} from a central difference at eps {eps} (limit {ZOO_TOL['jvp']}); "
          f"{jvp_ms:.0f} ms", flush=True)
    return out


def ode_zoo_phase(torch, dev):
    """Phase 9 (module docstring): the JAX package's stiff, event,
    Hamiltonian, multistep, per-element and CNF workloads on the card."""
    from paddlexde_tpu_torch.ops import _build

    _build.reset_launches()
    print(f"phase 9: the rest of the ODE solver zoo (float32 on the card unless marked; each "
          f"against the port's float64 solve on the CPU); card {card_line()}", flush=True)
    start = time.perf_counter()
    out = {}
    out.update(robertson_runs(torch, dev))
    out.update(kpp_runs(torch, dev))
    out.update(event_runs(torch, dev))
    out.update(pendulum_and_adams_runs(torch, dev))
    out.update(per_element_cnf_jvp_runs(torch, dev))
    launched = {k: v for k, v in _build.LAUNCHES.items() if v}
    require(not launched, f"phase 9 launched port kernels: {launched}")
    print(f"phase 9 took {time.perf_counter() - start:.1f} s", flush=True)
    return out


# --------------------------------------------------------------------------
# phase 10: the CDE half and the SDE core (no kernel of their own): the JAX
# package's SDE and CDE examples at full size on the card, in float32 unless
# marked, each against the port's float64 solve on the CPU from the same key
# (the CPU tests tie that solve to the JAX package)
# --------------------------------------------------------------------------

# the workloads' sizes: the examples' own, batched (the demos run one sample
# or a few paths; here 2048-4096 of them at once)
SDE_SIZES = {
    # examples/sde_demo.py:28-42 and its solver list (:80)
    "spiral_batch": 4096, "spiral_outputs": 1000, "spiral_t1": 25.0, "spiral_sigma": 0.02,
    # the spiral's leading trajectories held against the CPU, over the
    # card's first 250 steps and (started from the card's state) its last
    # 250: the late steps query the tree after its plan cache has turned
    # over
    "spiral_rows": 64, "spiral_check_steps": 250,
    # strong order: GBM dS = mu S dt + sigma S dW against its closed form
    # over [0, 1] at dt = 2^-4 .. 2^-8; sra1 on a nonlinear drift with
    # time-dependent additive noise at dt = 2^-2 .. 2^-4 against itself at
    # the finest dt / 64
    "order_paths": 4096, "gbm_mu": 0.5, "gbm_sigma": 0.8, "gbm_levels": (4, 5, 6, 7, 8),
    "sra1_levels": (2, 3, 4), "sra1_ref_factor": 64,
    # examples/sde_general_demo.py:55-66
    "general_paths": 2048, "general_outputs": 65, "general_rows": 32,
    # examples/cde_demo.py:55-68 (HIDDEN 16, 32 observations, rk4 on 65 nodes)
    "cde_samples": 4096, "cde_hidden": 16, "cde_obs": 32, "cde_grid": 65,
    # examples/logode_dde_demo.py:40-58
    "logode_knots": 4096, "logode_windows": 16, "logode_substeps": 8,
}
# the card's float32 against the CPU, max |diff| over the reference's max
# |value|, on the leading rows of each batch (a batch's leading rows are a
# smaller batch's path with the same key). Two references from the same
# key: the CPU's float32 solve (the same plan, bits and arithmetic: only the
# card's rounding differs, a few ulps of log1p in a normal), and the CPU's
# float64 solve of the same path (drawn under
# ``virtual_tree._noise_dtype(float32)``: JAX draws a float32 normal from 32
# bits and a float64 one from 64, so without it the two would be different
# paths). Against float64 the float32 tree's own resolution shows: it
# resolves query times and midpoints in float32, and at depth 24 over a
# span of 25 its deepest level (25 / 2^24 = 1.5e-6) is below float32's
# spacing past t = 16 (1.9e-6), so the deepest midpoints round. One rounded
# level moves W by about sqrt(1.5e-6) = 1.2e-3, 6e-5 of max |W| ~ 20 over
# 4096 paths; tree_w (3e-4) allows a few such levels (at t = 0.025, 2.5,
# 12.5 and 25: 4.0e-5 for the CPU's float32 tree on the first 64 paths,
# which the card's follows within tree_w_f32). The spiral's last 250 steps lie
# past t = 18.7, where every query rounds so, and its |y| has decayed to
# ~0.3 of its start: spiral_late against float64 there (the CPU's float32
# solve, which the card's follows within spiral_f32, measured 1.37e-4 for
# euler and milstein, 2.67e-4 for sriw1, 3.07e-4 for heun_stratonovich),
# spiral over the first 250 steps
SDE_TOL = {"spiral_f32": 1e-5, "spiral": 1e-4, "spiral_late": 1e-3,
           "tree_w_f32": 1e-5, "tree_w": 3e-4,
           "general_f32": 1e-5, "general": 2e-5, "foster2_f32": 1e-5, "foster2": 2e-5,
           "cde": 1e-5, "cde_grad": 2e-5, "logode": 1e-5, "order_f64": 1e-10}
# a long run's launches a step and idle share come from a profiled run of
# its first steps (``zoo_sliced``): a trace of every launch of a 999-step
# solve (~10^5-10^6 launches) costs more than the solve
PROFILED_STEPS = 50
# the neural CDE's profiled run: the forward and gradient on a 9-node grid
CDE_PROFILED_GRID = 9
# the fitted strong orders against the registry's (the issue's band)
ORDER_BAND = 0.15
SRA1_ORDER = (1.25, 1.75)
# the CDE gradient by the adjoint against autograd's, both on the card:
# both approximate the same derivative on the 64-step grid (the adjoint
# integrates the augmented system backward; measured on the CPU in float64)
CDE_ADJOINT_TOL = 1e-2


def _rel_err(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


def bm_query_launches(torch, dev, mode, size, dtype, n=20):
    """Launches per Brownian query (profiler) and host time per query of a
    bm of ``mode``, from ``n`` queries of its richest kind."""
    from paddlexde_tpu_torch import BrownianInterval

    kw = {"none": {}, "space-time": {"return_U": True},
          "space-time-time": {"return_U": True, "return_K": True},
          "davie": {"return_U": True, "return_A": True}}[mode]
    bm = BrownianInterval(0.0, 1.0, size=size, dtype=dtype, key=3,
                          levy_area_approximation=mode, device=dev)
    bm(0.0, 0.5, **kw)  # the first query's tables and allocations
    _, fig = zoo_run(torch, dev, lambda: [bm(i / n, (i + 1) / n, **kw) for i in range(n)],
                     steps=n)
    return fig


def spiral_sde_runs(torch, dev):
    """(a) The noisy spiral of examples/sde_demo.py with euler, milstein,
    sriw1 and heun_stratonovich, key 0, and the tree's W on the card."""
    import numpy as np

    from paddlexde_tpu_torch import BrownianInterval, sdeint
    from paddlexde_tpu_torch.brownian.virtual_tree import _noise_dtype

    sizes = SDE_SIZES
    n, outputs, t1 = sizes["spiral_batch"], sizes["spiral_outputs"], sizes["spiral_t1"]
    sigma = sizes["spiral_sigma"]
    a_np = np.array([[-0.1, 2.0], [-2.0, -0.1]])
    rows, check = sizes["spiral_rows"], sizes["spiral_check_steps"]
    t = np.linspace(0.0, t1, outputs)
    # the first and the last ``check`` steps
    windows = (slice(0, check + 1), slice(outputs - 1 - check, outputs))

    def problem(dtype, device, count):
        a = torch.tensor(a_np, dtype=dtype, device=device)
        y0 = torch.zeros(count, 2, dtype=dtype, device=device)
        y0[:, 0] = 2.0
        return (lambda t, y: y @ a), (lambda t, y: torch.full_like(y, sigma)), y0

    f32, g32, y32 = problem(torch.float32, dev, n)
    cpu = torch.device("cpu")
    refs = {dtype: problem(dtype, cpu, rows)[:2] for dtype in (torch.float32, torch.float64)}
    out = {}
    for name in ("euler", "milstein", "sriw1", "heun_stratonovich"):
        mode = "space-time" if name == "sriw1" else "none"
        sol, fig = zoo_run(torch, dev, lambda: sdeint(f32, g32, y32, t, name, key=0,
                                                       time_axis=0), steps=outputs - 1,
                           profile=False)
        zoo_sliced(torch, dev, fig, lambda: sdeint(f32, g32, y32, t[:PROFILED_STEPS + 1], name,
                                                   key=0, time_axis=0),
                   PROFILED_STEPS, outputs - 1)
        errs = {}
        for dtype, (f, g) in refs.items():
            bm = BrownianInterval(0.0, t1, size=(rows, 2), dtype=dtype, key=0,
                                  levy_area_approximation=mode, device=cpu)
            for w in windows:
                card = sol[w, :rows]
                with _noise_dtype(torch.float32):
                    ref = sdeint(f, g, card[0].to(cpu, dtype), t[w], name, bm=bm, time_axis=0)
                errs[dtype, w.start] = _rel_err(card, ref)
        e32 = max(errs[torch.float32, w.start] for w in windows)
        early, late = (errs[torch.float64, w.start] for w in windows)
        limits = (SDE_TOL["spiral_f32"], SDE_TOL["spiral"], SDE_TOL["spiral_late"])
        require(bool(torch.isfinite(sol).all())
                and all(e <= lim for e, lim in zip((e32, early, late), limits)),
                f"spiral {name}: {e32:.3e} from the CPU's float32 solve of {rows} rows, "
                f"{early:.3e} / {late:.3e} from its float64 solve over the first / last {check} "
                f"steps (limits {limits})")
        zoo_line(f"noisy spiral {name}, {n} paths, {outputs} outputs over [0, {t1:g}]", fig,
                 f"the first {rows} paths {e32:.2e} from the CPU's float32 solve, {early:.2e} / "
                 f"{late:.2e} from its float64 solve over the first / last {check} steps (limits "
                 f"{limits[0]}, {limits[1]} / {limits[2]}); y(25) spread "
                 f"{sol[-1].std(0).mean().item():.4f}")
        out[f"spiral_{name}"] = fig
    # the tree itself: W(0, t_i) on the card in float32 against the CPU's
    bm32 = BrownianInterval(0.0, t1, size=(n, 2), dtype=torch.float32, key=0, device=dev)
    w_errs = []
    for dtype in (torch.float32, torch.float64):
        ref_bm = BrownianInterval(0.0, t1, size=(rows, 2), dtype=dtype, key=0, device=cpu)
        with _noise_dtype(torch.float32):
            w_errs.append(max(_rel_err(bm32(0.0, float(ti))[:rows], ref_bm(0.0, float(ti)))
                              for ti in t[[1, 100, 500, 999]]))
    require(w_errs[0] <= SDE_TOL["tree_w_f32"] and w_errs[1] <= SDE_TOL["tree_w"],
            f"the tree's W on the card: {w_errs[0]:.3e} / {w_errs[1]:.3e} from the CPU's float32 "
            f"/ float64, limits {SDE_TOL['tree_w_f32']} / {SDE_TOL['tree_w']}")
    print(f"  the tree's W(t) at 4 query times, float32 on the card: {w_errs[0]:.2e} / "
          f"{w_errs[1]:.2e} from the CPU's float32 / float64 (limits {SDE_TOL['tree_w_f32']} / "
          f"{SDE_TOL['tree_w']})", flush=True)
    return out


def fitted_order(dts, errs):
    import numpy as np

    return float(np.polyfit(np.log(dts), np.log(errs), 1)[0])


def strong_order_runs(torch, dev):
    """(b) Strong orders on the card in float64: euler and milstein on GBM
    against its closed form, sra1 on an OU problem against itself at dt/64."""
    import numpy as np

    from paddlexde_tpu_torch import BrownianInterval, sdeint

    sizes = SDE_SIZES
    f64 = torch.float64
    n = sizes["order_paths"]
    mu, sig = sizes["gbm_mu"], sizes["gbm_sigma"]
    bm = BrownianInterval(0.0, 1.0, size=(n, 1), dtype=f64, key=1, device=dev)
    y0 = torch.ones(n, 1, dtype=f64, device=dev)
    exact = torch.exp((mu - 0.5 * sig**2) + sig * bm(0.0, 1.0))
    out = {}
    for name, want in (("euler", 0.5), ("milstein", 1.0)):
        errs, dts, figs = [], [], []
        for k in sizes["gbm_levels"]:
            t = np.linspace(0.0, 1.0, 2**k + 1)
            sol, fig = zoo_run(torch, dev, lambda: sdeint(
                lambda t, y: mu * y, lambda t, y: sig * y, y0, t, name, bm=bm, time_axis=0),
                steps=2**k, profile=False)
            errs.append((sol[-1] - exact).abs().mean().item())
            dts.append(2.0**-k)
            figs.append(fig)
        zoo_sliced(torch, dev, figs[-1], lambda: sdeint(
            lambda t, y: mu * y, lambda t, y: sig * y, y0, t[:PROFILED_STEPS + 1], name, bm=bm,
            time_axis=0), PROFILED_STEPS, 2 ** sizes["gbm_levels"][-1])
        order = fitted_order(dts, errs)
        require(abs(order - want) <= ORDER_BAND, f"GBM {name}: fitted strong order {order:.3f}, "
                f"registry {want} +- {ORDER_BAND} (errors {errs})")
        zoo_line(f"GBM {name} (float64), {n} paths, dt 2^-{sizes['gbm_levels'][0]}.."
                 f"2^-{sizes['gbm_levels'][-1]}", figs[-1],
                 f"strong order {order:.3f} (registry {want}), E|S - S_exact| "
                 + ", ".join(f"{e:.2e}" for e in errs) + "; the finest level's figures")
        out[f"gbm_{name}"] = dict(figs[-1], order=order)
    # the card's float64 solve against the CPU's on the leading rows
    rows = 32
    t = np.linspace(0.0, 1.0, 2 ** sizes["gbm_levels"][-1] + 1)
    bm_cpu = BrownianInterval(0.0, 1.0, size=(rows, 1), dtype=f64, key=1, device="cpu")
    card = sdeint(lambda t, y: mu * y, lambda t, y: sig * y, y0, t, "milstein", bm=bm,
                  time_axis=0)
    cpu = sdeint(lambda t, y: mu * y, lambda t, y: sig * y, y0[:rows].cpu(), t, "milstein",
                 bm=bm_cpu, time_axis=0)
    err64 = _rel_err(card[:, :rows], cpu)
    require(err64 <= SDE_TOL["order_f64"], f"GBM milstein float64: {err64:.3e} from the CPU's, "
            f"limit {SDE_TOL['order_f64']}")

    # sra1: dy = -2 sin(y) dt + 2 (1 + t) dW against itself at the finest
    # dt / 64 (a linear drift shows order ~2 on these steps, its drift error
    # leading; this nonlinear one ~1.45 on the CPU at 512 paths)
    bm_st = BrownianInterval(0.0, 1.0, size=(n, 1), dtype=f64, key=2,
                             levy_area_approximation="space-time", device=dev)
    drift = lambda t, y: -2.0 * torch.sin(y)  # noqa: E731
    diffusion = lambda t, y: 2.0 * (1.0 + t) + 0.0 * y  # noqa: E731
    finest = sizes["sra1_levels"][-1]
    n_ref = 2**finest * sizes["sra1_ref_factor"]
    ref, ref_fig = zoo_run(torch, dev, lambda: sdeint(
        drift, diffusion, y0, np.linspace(0.0, 1.0, n_ref + 1), "sra1", bm=bm_st,
        time_axis=0)[-1], steps=n_ref, profile=False)
    zoo_sliced(torch, dev, ref_fig, lambda: sdeint(
        drift, diffusion, y0, np.linspace(0.0, 1.0, n_ref + 1)[:PROFILED_STEPS + 1], "sra1",
        bm=bm_st, time_axis=0), PROFILED_STEPS, n_ref)
    errs, dts = [], []
    for k in sizes["sra1_levels"]:
        sol = sdeint(drift, diffusion, y0, np.linspace(0.0, 1.0, 2**k + 1), "sra1", bm=bm_st,
                     time_axis=0)[-1]
        errs.append((sol - ref).abs().mean().item())
        dts.append(2.0**-k)
    order = fitted_order(dts, errs)
    require(SRA1_ORDER[0] <= order <= SRA1_ORDER[1], f"sra1: fitted strong order {order:.3f}, "
            f"band {SRA1_ORDER} (errors {errs})")
    zoo_line(f"sra1 (float64), dy = -2 sin(y) dt + 2(1 + t) dW, {n} paths, dt 2^-"
             f"{sizes['sra1_levels'][0]}..2^-{finest} against dt 2^-{finest} / "
             f"{sizes['sra1_ref_factor']}", ref_fig,
             f"strong order {order:.3f} (registry 1.5), errors "
             + ", ".join(f"{e:.2e}" for e in errs) + f"; milstein's card float64 against the "
             f"CPU's {err64:.1e}; the reference solve's figures")
    out["sra1"] = dict(ref_fig, order=order)
    return out


def general_noise_runs(torch, dev):
    """(c) examples/sde_general_demo.py: milstein_general with Davie areas
    (key 42, noise_dim 2), the terminal log-return covariance against
    L L^T T; foster2 with the space-time-time tree on an additive problem."""
    import numpy as np

    from paddlexde_tpu_torch import BrownianInterval, sdeint
    from paddlexde_tpu_torch.brownian.virtual_tree import _noise_dtype

    sizes = SDE_SIZES
    n, outputs = sizes["general_paths"], sizes["general_outputs"]
    rows = sizes["general_rows"]
    mu_np = np.array([0.05, 0.03])
    l_np = np.array([[0.30, 0.0], [0.12, 0.25]])
    t = np.linspace(0.0, 1.0, outputs)

    def problem(dtype, device, count):
        mu = torch.tensor(mu_np, dtype=dtype, device=device)
        l_mat = torch.tensor(l_np, dtype=dtype, device=device)
        return ((lambda t, s: mu * s), (lambda t, s: s[..., :, None] * l_mat),
                torch.ones(count, 2, dtype=dtype, device=device))

    f32, g32, s32 = problem(torch.float32, dev, n)
    cpu = torch.device("cpu")
    sol, fig = zoo_run(torch, dev, lambda: sdeint(
        f32, g32, s32, t, "milstein_general", key=42, noise_dim=2, time_axis=0,
        levy_area_approximation="davie"), steps=outputs - 1)
    errs = []
    for dtype in (torch.float32, torch.float64):
        f, g, s0 = problem(dtype, cpu, rows)
        bm = BrownianInterval(0.0, 1.0, size=(rows, 2), dtype=dtype, key=42, device=cpu,
                              levy_area_approximation="davie")
        with _noise_dtype(torch.float32):
            errs.append(_rel_err(sol[:, :rows], sdeint(f, g, s0, t, "milstein_general", bm=bm,
                                                       time_axis=0)))
    log_r = torch.log(sol[-1]).double().cpu().numpy()
    cov = np.cov(log_r.T)
    want = l_np @ l_np.T
    # the standard error of a sample covariance entry: sqrt((S_ii S_jj + S_ij^2) / n)
    se = np.sqrt((np.outer(np.diag(want), np.diag(want)) + want**2) / n)
    z = float(np.max(np.abs(cov - want) / se))
    require(errs[0] <= SDE_TOL["general_f32"] and errs[1] <= SDE_TOL["general"] and z <= 4.0,
            f"milstein_general: {errs[0]:.3e} / {errs[1]:.3e} from the CPU's float32 / float64 "
            f"rows (limits {SDE_TOL['general_f32']} / {SDE_TOL['general']}); covariance "
            f"{cov.round(5).tolist()} against L L^T {want.round(5).tolist()}, {z:.2f} standard "
            f"errors (limit 4)")
    zoo_line(f"milstein_general + Davie areas, {n} paths, {outputs} outputs, key 42", fig,
             f"{errs[0]:.2e} / {errs[1]:.2e} from the CPU's float32 / float64 on {rows} rows "
             f"(limits {SDE_TOL['general_f32']} / {SDE_TOL['general']}); log-return covariance "
             f"{cov.round(4).tolist()} vs L L^T {want.round(4).tolist()} ({z:.2f} standard "
             f"errors at most)")
    out = {"milstein_general": fig}

    # foster2: dy = -y dt + 0.3 (1 + t) dW, diagonal, the (W, I10, K) triple
    drift = lambda t, y: -y  # noqa: E731
    diffusion = lambda t, y: 0.3 * (1.0 + t) + 0.0 * y  # noqa: E731
    y32 = torch.ones(n, 2, device=dev)
    sol, fig = zoo_run(torch, dev, lambda: sdeint(drift, diffusion, y32, t, "foster2", key=5,
                                                  time_axis=0), steps=outputs - 1)
    errs = []
    for dtype in (torch.float32, torch.float64):
        bm = BrownianInterval(0.0, 1.0, size=(rows, 2), dtype=dtype, key=5, device=cpu,
                              levy_area_approximation="space-time-time")
        with _noise_dtype(torch.float32):
            errs.append(_rel_err(sol[:, :rows], sdeint(drift, diffusion, torch.ones(
                rows, 2, dtype=dtype), t, "foster2", bm=bm, time_axis=0)))
    require(errs[0] <= SDE_TOL["foster2_f32"] and errs[1] <= SDE_TOL["foster2"],
            f"foster2: {errs[0]:.3e} / {errs[1]:.3e} from the CPU's float32 / float64 rows, "
            f"limits {SDE_TOL['foster2_f32']} / {SDE_TOL['foster2']}")
    zoo_line(f"foster2 (space-time-time tree), OU with 0.3(1 + t) noise, {n} x 2, {outputs} "
             f"outputs", fig, f"{errs[0]:.2e} / {errs[1]:.2e} from the CPU's float32 / float64 "
             f"on {rows} rows (limits {SDE_TOL['foster2_f32']} / {SDE_TOL['foster2']})")
    out["foster2"] = fig
    return out


def cde_data(np, sizes, seed=0):
    """examples/cde_demo.py's dataset and parameters (make_dataset,
    init_params) at ``cde_samples`` samples, from one seeded generator."""
    rng = np.random.RandomState(seed)
    n, n_obs, hidden = sizes["cde_samples"], sizes["cde_obs"], sizes["cde_hidden"]
    ts = np.sort(rng.rand(n, n_obs), axis=1) * 4 * np.pi
    label = rng.randint(0, 2, n)
    sign = np.where(label == 0, 1.0, -1.0)[:, None]
    x = np.stack([np.cos(sign * ts) + rng.randn(n, n_obs) * 0.05,
                  np.sin(sign * ts) + rng.randn(n, n_obs) * 0.05, ts / (4 * np.pi)], axis=-1)
    params = {"in_w": rng.randn(3, hidden) * 0.3, "f_w1": rng.randn(hidden, 64) * 0.1,
              "f_b1": np.zeros(64), "f_w2": rng.randn(64, hidden * 3) * 0.1,
              "out_w": rng.randn(hidden, 1) * 0.3}
    return x, label.astype(np.float64), params


def cde_inputs(torch, x_np, label_np, params_np, sizes, dtype, device):
    """The demo's tensors on ``device``: parameters (leaves that need a
    gradient), the series, the labels and the normalised knots."""
    p = {k: torch.tensor(v, dtype=dtype, device=device, requires_grad=True)
         for k, v in params_np.items()}
    return (p, torch.tensor(x_np, dtype=dtype, device=device),
            torch.tensor(label_np, dtype=dtype, device=device),
            torch.linspace(0.0, 1.0, sizes["cde_obs"], dtype=dtype, device=device))


def cde_loss(torch, inputs, sizes, adjoint=False):
    """The demo's model on the whole batch: the series' cubic Hermite
    control over 32 normalised knots, y0 = x_0 @ in_w, cdeint with rk4 on
    the 65-node grid, the logit sol[-1] @ out_w; the mean binary
    cross-entropy, its parameter gradients and y(1)."""
    import numpy as np

    from paddlexde_tpu_torch import CubicHermiteSpline, cdeint

    p, x, label, knots = inputs
    hidden = sizes["cde_hidden"]
    control = CubicHermiteSpline(x, knots)
    y0 = x[:, 0] @ p["in_w"]

    def field(t, y):
        h = torch.tanh(y @ p["f_w1"] + p["f_b1"])
        return torch.tanh(h @ p["f_w2"]).reshape(y.shape[:-1] + (hidden, 3))

    grid = np.linspace(0.0, 1.0, sizes["cde_grid"])
    kw = {"adjoint_params": [p["f_w1"], p["f_b1"], p["f_w2"]]} if adjoint else {}
    sol = cdeint(field, y0, np.array([0.0, 1.0]), control, "rk4", options={"grid": grid},
                 adjoint=adjoint, time_axis=0, **kw)
    logit = (sol[-1] @ p["out_w"])[:, 0]
    loss = torch.nn.functional.binary_cross_entropy_with_logits(logit, label)
    grads = torch.autograd.grad(loss, list(p.values()))
    return loss.detach(), dict(zip(p, grads)), sol[-1].detach()


def neural_cde_runs(torch, dev):
    """(d) examples/cde_demo.py's neural CDE on 4096 samples: the forward
    and the parameter gradient by autograd and by the adjoint, with peak
    memory, against the CPU's float64."""
    import numpy as np

    sizes = SDE_SIZES
    x, label, params = cde_data(np, sizes)
    inputs = cde_inputs(torch, x, label, params, sizes, torch.float32, dev)
    runs = {}
    for adjoint in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        (loss, grads, y1), fig = zoo_run(torch, dev, lambda: cde_loss(
            torch, inputs, sizes, adjoint), steps=sizes["cde_grid"] - 1, profile=False)
        fig["peak_mb"] = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
        short = dict(sizes, cde_grid=CDE_PROFILED_GRID)
        zoo_sliced(torch, dev, fig, lambda: cde_loss(torch, inputs, short, adjoint),
                   CDE_PROFILED_GRID - 1, sizes["cde_grid"] - 1)
        runs[adjoint] = (loss, grads, y1, fig)
    loss64, grads64, y64 = cde_loss(torch, cde_inputs(torch, x, label, params, sizes,
                                                      torch.float64, torch.device("cpu")), sizes)
    loss, grads, y1, fig = runs[False]
    err = _rel_err(y1, y64)
    grad_err = max(_rel_err(grads[k], grads64[k]) for k in grads)
    adj_gap = max(_rel_err(runs[True][1][k], grads[k]) for k in grads)
    require(err <= SDE_TOL["cde"] and grad_err <= SDE_TOL["cde_grad"]
            and adj_gap <= CDE_ADJOINT_TOL,
            f"neural CDE: y(1) {err:.3e} from the CPU's float64 (limit {SDE_TOL['cde']}), "
            f"gradient {grad_err:.3e} (limit {SDE_TOL['cde_grad']}), adjoint against autograd "
            f"{adj_gap:.3e} (limit {CDE_ADJOINT_TOL})")
    zoo_line(f"neural CDE, {sizes['cde_samples']} samples x {sizes['cde_obs']} observations, "
             f"hidden {sizes['cde_hidden']}, rk4 on {sizes['cde_grid']} nodes, loss + autograd "
             f"gradient", fig,
             f"loss {loss.item():.5f} (float64 {loss64.item():.5f}); y(1) {err:.2e} and the "
             f"gradient {grad_err:.2e} from the CPU's float64 (limits {SDE_TOL['cde']}, "
             f"{SDE_TOL['cde_grad']}); peak {fig['peak_mb']:.1f} MiB")
    afig = runs[True][3]
    zoo_line("the same gradient by adjoint=True", afig,
             f"{adj_gap:.2e} from autograd's (limit {CDE_ADJOINT_TOL}); peak "
             f"{afig['peak_mb']:.1f} MiB against autograd's {fig['peak_mb']:.1f}")
    return {"cde": fig, "cde_adjoint": afig}


def logode_runs(torch, dev):
    """(e) examples/logode_dde_demo.py's log-ODE part: the 4096-knot random
    walk, 16 windows x 8 substeps at depth 1, 2, 3 against the fine oracle
    (cdeint, rk4 at the knot spacing on the linear interpolation, in
    float64 on the CPU); the natural spline's build over the same knots."""
    import numpy as np

    from paddlexde_tpu_torch import LinearInterpolation, NaturalCubicSpline, cdeint, cdeint_logode

    knots, windows, substeps = (SDE_SIZES["logode_knots"], SDE_SIZES["logode_windows"],
                                SDE_SIZES["logode_substeps"])
    rng = np.random.default_rng(1)
    b1 = np.array([[0.0, 1.0], [0.0, 0.0]]) * 0.8
    b2 = np.array([[0.0, 0.0], [1.0, 0.0]]) * 0.8
    x_np = rng.normal(size=(knots + 1, 2)).cumsum(0) * 0.016
    tx = np.linspace(0.0, 1.0, knots + 1)
    ts = np.linspace(0.0, 1.0, windows + 1)

    def setup(dtype, device):
        b1t = torch.tensor(b1, dtype=dtype, device=device)
        b2t = torch.tensor(b2, dtype=dtype, device=device)
        f = lambda t, y: torch.stack([y @ b1t.T, y @ b2t.T], dim=-1)  # noqa: E731
        x = torch.tensor(x_np, dtype=dtype, device=device)
        knot_t = torch.tensor(tx, dtype=dtype, device=device)
        y0 = torch.tensor([1.0, 0.5], dtype=dtype, device=device)
        return f, x, knot_t, y0

    f32, x32, t32, y32 = setup(torch.float32, dev)
    f64, x64, t64, y64 = setup(torch.float64, torch.device("cpu"))

    def oracle(f, x, knot_t, y0):
        return cdeint(f, y0, np.array([0.0, 1.0]), LinearInterpolation(x, knot_t), "rk4",
                      options={"step_size": 1.0 / knots}, time_axis=0)[-1]

    # the oracle in float64 on the CPU (on the card it is 4096 rk4 steps of
    # host-bound launches, ~11 s; neural_cde_runs drives cdeint there)
    start = time.perf_counter()
    ref64 = oracle(f64, x64, t64, y64)
    print(f"  the fine CDE oracle, rk4 over {knots} knots in float64 on the CPU: y(1) "
          f"{ref64.numpy().round(6).tolist()} ({(time.perf_counter() - start) * 1e3:.0f} ms)",
          flush=True)
    out = {}
    errs = []
    for depth in (1, 2, 3):
        sol, fig = zoo_run(torch, dev, lambda: cdeint_logode(
            f32, y32, ts, (x32, t32), depth=depth, substeps=substeps, time_axis=0),
            steps=windows * substeps, profile=False)
        zoo_sliced(torch, dev, fig, lambda: cdeint_logode(
            f32, y32, ts[:3], (x32, t32), depth=depth, substeps=substeps, time_axis=0),
            2 * substeps, windows * substeps)
        sol64 = cdeint_logode(f64, y64, ts, (x64, t64), depth=depth, substeps=substeps,
                              time_axis=0)
        cpu_err = _rel_err(sol, sol64)
        errs.append(float((sol[-1].double().cpu() - ref64).abs().max()))
        require(cpu_err <= SDE_TOL["logode"], f"log-ODE depth {depth}: {cpu_err:.3e} from the "
                f"CPU's float64, limit {SDE_TOL['logode']}")
        zoo_line(f"log-ODE depth {depth}, {windows} windows x {substeps} rk4 substeps", fig,
                 f"error {errs[-1]:.2e} against the float64 oracle; {cpu_err:.2e} from the "
                 f"CPU's float64 solve (limit {SDE_TOL['logode']})")
        out[f"logode_{depth}"] = fig
    require(errs[0] > errs[1] > errs[2], f"the log-ODE error must fall with depth: {errs}")
    spline, fig = zoo_run(torch, dev, lambda: NaturalCubicSpline(x32, t32), steps=1)
    d_err = _rel_err(spline.derivative(torch.tensor(tx[1:-1:97], dtype=torch.float32,
                                                    device=dev)),
                     NaturalCubicSpline(x64, t64).derivative(torch.tensor(tx[1:-1:97])))
    require(d_err <= SDE_TOL["logode"], f"NaturalCubicSpline over {knots + 1} knots: derivative "
            f"{d_err:.3e} from the CPU's float64, limit {SDE_TOL['logode']}")
    zoo_line(f"NaturalCubicSpline build over {knots + 1} knots (cyclic reduction)", fig,
             f"its derivative {d_err:.2e} from the CPU's float64 (limit {SDE_TOL['logode']})")
    out["natural_spline"] = fig
    return out


def sde_cde_phase(torch, dev):
    """Phase 10 (module docstring): the CDE half and the SDE core, the JAX
    package's SDE and CDE examples at full size on the card."""
    from paddlexde_tpu_torch.ops import _build

    sizes = SDE_SIZES
    _build.reset_launches()
    print(f"phase 10: CDEs and the SDE core (float32 on the card unless marked; each against "
          f"the port's float64 solve on the CPU from the same key); card {card_line()}",
          flush=True)
    start = time.perf_counter()
    out = {}
    for mode, size in (("none", (sizes["spiral_batch"], 2)),
                       ("space-time", (sizes["spiral_batch"], 2)),
                       ("space-time-time", (sizes["general_paths"], 2)),
                       ("davie", (sizes["general_paths"], 2))):
        fig = bm_query_launches(torch, dev, mode, size, torch.float32)
        zoo_line(f"Brownian queries, mode {mode}, size {size}, float32", fig,
                 "a step here is one query")
        out[f"query_{mode}"] = fig
    out.update(spiral_sde_runs(torch, dev))
    out.update(strong_order_runs(torch, dev))
    out.update(general_noise_runs(torch, dev))
    out.update(neural_cde_runs(torch, dev))
    out.update(logode_runs(torch, dev))
    launched = {k: v for k, v in _build.LAUNCHES.items() if v}
    require(not launched, f"phase 10 launched port kernels: {launched}")
    print(f"phase 10 took {time.perf_counter() - start:.1f} s", flush=True)
    return out


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
    spiral_phase(torch, dev)
    ref_served, cli_train, dde_adjoint = dde_extras_phase(torch, dev)
    ode_zoo_phase(torch, dev)
    sde_cde_phase(torch, dev)
    pems = [serve_launches, bf16_launches, train_launches, bf16_train_launches,
            *(d[0] for d in dropout.values()), ref_served, dde_adjoint]
    # the CLI's synthetic configuration has SYNTH's widths (D = 64)
    synth = [synth_serve, synth_train, *(d[0] for d in synth_dropout.values()), cli_train]
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
