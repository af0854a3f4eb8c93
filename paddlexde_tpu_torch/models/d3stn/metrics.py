"""Masked accuracy metrics + interval score (numpy).

The port's own copy of ``paddlexde_tpu/models/d3stn/metrics.py`` (importing
the JAX package would pull in JAX). Same definitions as the reference
(``example/D3STN/metrics.py:15-62`` and ``utils.py:316-368`` in
DrownFish19/PaddleXDE) — these DEFINE accuracy parity,
so the math is kept bit-for-bit: mask = (y_true >= threshold), mean-normalized.
"""

from __future__ import annotations

import numpy as np

__all__ = ["MAE", "MSE", "RMSE", "MAPE", "smis"]


def _mask(y_true, threshold=0.9):
    with np.errstate(divide="ignore", invalid="ignore"):
        mask = np.greater_equal(y_true, threshold).astype(np.float32)
        mask /= np.mean(mask)
        return mask


def MSE(y_true, y_pred):
    with np.errstate(divide="ignore", invalid="ignore"):
        mse = np.square(np.subtract(y_pred, y_true))
        return float(np.mean(np.nan_to_num(mse * _mask(y_true))))


def RMSE(y_true, y_pred):
    with np.errstate(divide="ignore", invalid="ignore"):
        se = np.square(np.abs(np.subtract(y_pred, y_true)))
        return float(np.sqrt(np.mean(np.nan_to_num(se * _mask(y_true)))))


def MAE(y_true, y_pred):
    with np.errstate(divide="ignore", invalid="ignore"):
        ae = np.abs(np.subtract(y_pred, y_true))
        return float(np.mean(np.nan_to_num(ae * _mask(y_true))))


def MAPE(y_true, y_pred, null_val=0):
    with np.errstate(divide="ignore", invalid="ignore"):
        if np.isnan(null_val):
            mask = (~np.isnan(y_true)).astype(np.float32)
        else:
            mask = np.greater_equal(y_true, null_val).astype(np.float32)
        mask /= np.mean(mask)
        mape = np.abs(np.divide(np.subtract(y_pred, y_true).astype(np.float32), y_true))
        return float(np.mean(np.nan_to_num(mask * mape)) * 100)


def smis(y_true, y_pred, m=288, level=0.95):
    """Scaled mean interval score (reference ``utils.py:316-368``): interval
    from the empirical residual quantiles, scaled by the seasonal naive MAE."""
    alpha = 1 - level
    y_true = np.asarray(y_true, np.float64)
    y_pred = np.asarray(y_pred, np.float64)
    resid = y_true - y_pred
    lo_q = np.quantile(resid, alpha / 2, axis=-1, keepdims=True)
    hi_q = np.quantile(resid, 1 - alpha / 2, axis=-1, keepdims=True)
    lower = y_pred + lo_q
    upper = y_pred + hi_q
    mis = (
        (upper - lower)
        + (2.0 / alpha) * np.maximum(lower - y_true, 0)
        + (2.0 / alpha) * np.maximum(y_true - upper, 0)
    ).mean(axis=-1)
    if y_true.shape[-1] > m:
        scale = np.abs(y_true[..., m:] - y_true[..., :-m]).mean(axis=-1)
    else:
        scale = np.abs(np.diff(y_true, axis=-1)).mean(axis=-1)
    return float(np.mean(mis / np.maximum(scale, 1e-8)))
