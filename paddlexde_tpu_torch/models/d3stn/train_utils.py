"""Training-loop utilities: LR schedules, early stopping, logging, KL.

The port's own copy of ``paddlexde_tpu/models/d3stn/train_utils.py``, with
``kl_div`` in torch.

Rebuilds of ``example/D3STN/utils.py:14-107, 371-398`` (DrownFish19/PaddleXDE).
The schedules are pure functions of the epoch index (the reference steps its
LRScheduler once per epoch, ``train_dde.py:360``), returning a multiplicative
factor in [min_lr, max_lr] applied to each parameter group's base rate.
"""

from __future__ import annotations

import logging
import math
import os

import torch

__all__ = [
    "cosine_annealing_with_warmup",
    "linear_annealing_with_warmup",
    "EarlyStopping",
    "Logger",
    "kl_div",
]


def cosine_annealing_with_warmup(max_lr, min_lr, warmup_step, decay_step):
    """Reference ``CosineAnnealingWithWarmupDecay.get_lr`` (``utils.py:14-37``)."""

    def schedule(epoch: int) -> float:
        if warmup_step > 0 and epoch <= warmup_step:
            return float(max_lr) * epoch / warmup_step
        if epoch > decay_step:
            return float(min_lr)
        ratio = float(epoch - warmup_step) / float(decay_step - warmup_step)
        coeff = 0.5 * (math.cos(math.pi * ratio) + 1.0)
        return float(min_lr) + coeff * (float(max_lr) - float(min_lr))

    return schedule


def linear_annealing_with_warmup(max_lr, min_lr, warmup_step, decay_step):
    """Reference ``LinearAnnealingWithWarmupDecay`` (``utils.py:40-65``)."""

    def schedule(epoch: int) -> float:
        if warmup_step > 0 and epoch <= warmup_step:
            return float(max_lr) * epoch / warmup_step
        if epoch > decay_step:
            return float(min_lr)
        ratio = float(epoch - warmup_step) / float(decay_step - warmup_step)
        return float(min_lr) + (1.0 - ratio) * (float(max_lr) - float(min_lr))

    return schedule


class EarlyStopping:
    """Reference ``utils.py:371-398``: stop after `patience` epochs without a
    val-loss improvement of more than `delta`."""

    def __init__(self, patience=15, delta=0.0):
        self.patience = patience
        self.delta = delta
        self.reset()

    def reset(self):
        self.counter = 0
        self.best = None
        self.early_stop = False

    def __call__(self, val_loss: float):
        if self.best is None or val_loss < self.best - self.delta:
            self.best = val_loss
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True


class Logger:
    """Process-0-gated file+console logger (reference ``utils.py:67-107``)."""

    def __init__(self, name: str, log_file: str, is_main: bool = True):
        self.is_main = is_main
        self.log_file = log_file
        self._logger = logging.getLogger(f"{name}:{log_file}")
        self._logger.setLevel(logging.INFO)
        if is_main and not self._logger.handlers:
            os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
            fh = logging.FileHandler(log_file)
            fh.setFormatter(
                logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
            )
            self._logger.addHandler(fh)
            sh = logging.StreamHandler()
            sh.setFormatter(logging.Formatter("%(message)s"))
            self._logger.addHandler(sh)

    def _log(self, level, message):
        if self.is_main:
            getattr(self._logger, level)(message)

    def info(self, message):
        self._log("info", message)

    def warning(self, message):
        self._log("warning", message)

    def debug(self, message):
        self._log("debug", message)

    def error(self, message):
        self._log("error", message)


def kl_div(log_q, p, reduction: str = "mean"):
    """KL(p || q) from log-probabilities of q — paddle ``F.kl_div`` semantics
    (elementwise p*(log p - log q), reduced), used by the alignment losses
    (``train_dde.py:436-452, 516-525``)."""
    elem = torch.where(p > 0, p * (torch.log(torch.clamp(p, min=1e-38)) - log_q),
                       torch.zeros((), dtype=p.dtype, device=p.device))
    if reduction == "mean":
        return elem.mean()
    if reduction == "sum":
        return elem.sum()
    if reduction == "batchmean":
        return elem.sum() / p.shape[0]
    return elem
