"""The index map of K5 bf16's weight-gradient kernel, modelled on the CPU.

``attn_bwd_bf16_dw_kernel`` (``paddlexde_tpu_torch/ops/csrc/attn_bwd_bf16.cu``)
computes, for each of the four convs of the attention block,

    dW[j][c][f] = sum over rows and t of xpad[t + j][c] d[t][f],  db[f] = sum of d[t][f]

without a shift per tap: a tile of 8 rows is laid out as 14 time slots per
row, x[t] at slot row 14 + t + pad_left (zeros at the halo slots) and d[t]
at slot row 14 + t (zeros at the last two), so pair k = row 14 + t meets x at
slot k + j in tap j. The tile's 112 slots are 7 k-steps of 16; each tap
sums the k-steps {0, 1, 2}, {3, 4, 5}, {6} as chains added to its float32
sum; the rows go to splits of whole tiles (``attn.bf16_dw_splits``), whose
partials are summed in split order. The bias sums run over the tile's
slots in 256 / D parts, added in part order.

This file walks exactly those tiles, slots, taps, chains, parts and splits
in numpy (float64) and holds the result against the port's plain weight
gradient (``attn._conv_weight_grads_plain``, an einsum per tap) within
1e-12, for D3STN's three flag sets (every conv's left padding), at ragged
row counts and at D = 64 and 128. A model that shifts x per tap in a
layout without the halo, so that a tap reaches into the next row, must
fail the same check.
"""

import numpy as np
import pytest
import torch

from paddlexde_tpu_torch.ops import attn

T, K = 12, 3
DR = 8            # rows per tile
TS = T + K - 1    # slots per row
DSL = DR * TS     # slots per tile
XCOL = DSL + K    # slots of an x column: the tile and the taps' overhang
CHAINS = ((0, 1, 2), (3, 4, 5), (6,))
THREADS = 256
# D3STN's flag sets -> (left padding, causal) of the q, k, v and out convs
FLAGS = {
    "encoder self": ((1, False), (1, False), (1, False), (1, False)),
    "decoder masked self": ((2, True), (2, True), (2, True), (1, False)),
    "decoder source": ((2, True), (1, False), (1, False), (1, False)),
}


def model_dw(x, g, padl, splits, halo=True):
    """dW [K, D, D] and db [D] of one conv as the kernel sums them. With
    ``halo=False`` the rows are packed 12 slots apart and tap j reads x at
    slot k + j - padl, zero only outside the tile: a shift that crosses
    rows."""
    rows, _, d = x.shape
    tiles = -(-rows // DR)
    rows_per_split = DR * -(-tiles // splits)
    parts = []
    for split in range(splits):
        acc = np.zeros((K, d, d))
        bias = np.zeros((THREADS // d, d))
        r_begin, r_end = split * rows_per_split, min(rows, (split + 1) * rows_per_split)
        for r0 in range(r_begin, r_end, DR):
            n = min(DR, r_end - r0)
            a = np.zeros((XCOL + K, d))  # [slot, channel] (the overhang of either layout)
            b = np.zeros((DSL, d))   # [slot, output]
            for r in range(n):
                if halo:
                    a[r * TS + padl : r * TS + padl + T] = x[r0 + r]
                    b[r * TS : r * TS + T] = g[r0 + r]
                else:
                    a[r * T + K : r * T + K + T] = x[r0 + r]
                    b[r * T : r * T + T] = g[r0 + r]
            for chain in CHAINS:
                for j in range(K):
                    off = j if halo else K + j - padl
                    acc[j] += sum(a[16 * ks + off : 16 * ks + off + 16].T @ b[16 * ks : 16 * ks + 16]
                                  for ks in chain)
            for q, part in enumerate(np.split(b, THREADS // d)):
                bias[q] += part.sum(axis=0)
        parts.append((acc, bias.sum(axis=0)))
    dw = np.zeros((K, d, d))
    db = np.zeros(d)
    for acc, bias in parts:
        dw += acc
        db += bias
    return dw, db


def _errors(rows, d, sms, flags, halo=True):
    rng = np.random.default_rng(rows * d + sms)
    splits = attn.bf16_dw_splits(rows, d, sms)
    errs = []
    for padl, causal in FLAGS[flags]:
        x = rng.standard_normal((rows, T, d))
        g = rng.standard_normal((rows, T, d))
        dw, db = model_dw(x, g, padl, splits, halo)
        want_dw, want_db = attn._conv_weight_grads_plain(torch.from_numpy(x), torch.from_numpy(g),
                                                         K, causal)
        errs.append(np.abs(dw - want_dw.numpy()).max() / np.abs(want_dw.numpy()).max())
        errs.append(np.abs(db - want_db.numpy()).max() / np.abs(want_db.numpy()).max())
    return max(errs)


# (rows, D, SMs): fewer rows than a tile; a ragged last tile, 5 splits; one
# split of 5 tiles; 13 tiles in 4 splits of 4, 4, 4 and 1 (a split count
# that does not divide the rows, a ragged last split)
SHAPES = [(5, 128, 132), (37, 64, 132), (37, 128, 8), (100, 64, 16)]


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("rows,d,sms", SHAPES)
def test_dw_index_map_matches_the_plain_weight_gradients(rows, d, sms, flags):
    assert _errors(rows, d, sms, flags) <= 1e-12


@pytest.mark.parametrize("flags", list(FLAGS))
def test_a_tap_shift_across_rows_fails(flags):
    assert _errors(37, 64, 132, flags, halo=False) > 1e-3


@pytest.mark.parametrize("d", [64, 128])
def test_dw_splits_fill_one_wave_without_an_empty_split(d):
    for sms in (8, 114, 132):
        for rows in (1, 5, 8, 9, 37, 340, 921, 5440, 28288):
            splits = attn.bf16_dw_splits(rows, d, sms)
            tiles = -(-rows // DR)
            per = -(-tiles // splits)
            assert 1 <= splits <= tiles
            assert splits * 4 * (d // 64) <= max(sms, 4 * (d // 64))
            assert (splits - 1) * per < tiles <= splits * per
