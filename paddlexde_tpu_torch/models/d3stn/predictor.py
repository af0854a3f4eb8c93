"""Standalone D3STN inference: checkpoint -> forecaster on the card.

Counterpart of ``paddlexde_tpu/models/d3stn/predictor.py``. It loads the JAX
Trainer's file-per-part checkpoint (``epoch_*.params`` pickle of numpy
arrays + ``.enidx/.deidx`` lag npys) without JAX, builds the model once on
the device, and serves ``[B, N, his_len, 3]`` histories as de-scaled
``[B, N, tgt_len]`` forecasts. One request batch runs

    history_index_pair(dec_idx, enc_idx)
                            -> spline kernel, once  (decoder input y0,
                                                     encoder input y_lags)
    ddeint(euler, t=[0, 1], his_processed=True)
                            -> D3STN once: 6 attention + 4 GCN kernel launches

PyTorch runs eagerly, so a ragged tail batch runs at its own size (the JAX
package pads it to its one compiled shape); every batch row is independent,
so the result is the same.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np
import torch

from ..._device import resolve_device
from ...functional.ddeint import ddeint
from ...xde.history import history_index_pair
from .config import D3STNConfig
from .graph import norm_adj_matrix
from .model import D3STN
from .weights import load_flax_params

__all__ = ["Predictor"]


class Predictor:
    """D3STN forecaster.

    Args:
        cfg: model config (must match the checkpoint).
        params: the flax parameter tree (nested dicts of numpy arrays, as
            the JAX Trainer saves it), or None to keep the model's random
            initialisation drawn from ``generator``.
        enc_idx / dec_idx: learned lag tensors ``[tgt_len]``.
        adj_matrix / sc_matrix: RAW adjacencies (normalised here, as the
            Trainer does).
        scaler: optional object with ``inverse_transform`` applied to the
            value channel of the output; None returns model-space values.
        batch_size: requests are served in chunks of this many windows.
        device: CUDA by default (raises when there is none); ``"cpu"`` runs
            the plain PyTorch versions of the kernels.
        generator: CPU ``torch.Generator`` for the random initialisation.
    """

    def __init__(self, cfg: D3STNConfig, params, enc_idx, dec_idx, adj_matrix,
                 sc_matrix, scaler=None, batch_size: int = 32, *, device=None,
                 generator: Optional[torch.Generator] = None):
        self.cfg = cfg
        self.scaler = scaler
        self.batch_size = int(batch_size)
        self.device = resolve_device(device)
        self.model = D3STN(
            cfg,
            norm_adj_matrix(np.asarray(adj_matrix)).astype(np.float32),
            norm_adj_matrix(np.asarray(sc_matrix)).astype(np.float32),
            device=self.device,
            generator=generator,
        )
        if params is not None:
            load_flax_params(self.model, params)
        self.model.eval()
        self.enc_idx = torch.as_tensor(np.asarray(enc_idx), device=self.device)
        self.dec_idx = torch.as_tensor(np.asarray(dec_idx), device=self.device)
        self.his_span = torch.arange(cfg.his_len, dtype=torch.float32, device=self.device)
        # the solver reads its grid on the host: keeping t_span there spares
        # a device-to-host sync per batch
        self.t_span = torch.arange(2.0, dtype=torch.float32)
        self._series_dev = None  # predict_series upload cache (id-keyed)
        self._series_src = None

    # ------------------------------------------------------------------ load
    @classmethod
    def from_checkpoint(cls, cfg: D3STNConfig, ckpt_dir: str, adj_matrix,
                        sc_matrix, *, epoch: Optional[int] = None,
                        scaler=None, batch_size: int = 32, device=None) -> "Predictor":
        """Load the Trainer's checkpoint layout from ``ckpt_dir``
        (``epoch_best`` by default, or a specific ``epoch``). The params file
        is a pickle: load only checkpoints this project's Trainer wrote."""
        tag = f"epoch_{epoch}" if epoch is not None else "epoch_best"
        pf = os.path.join(ckpt_dir, f"{tag}.params")
        if not os.path.exists(pf):
            raise FileNotFoundError(
                f"{pf} not found — expected the Trainer's file-per-part "
                f"layout (epoch_*.params / .enidx.npy / .deidx.npy)"
            )
        with open(pf, "rb") as f:
            params = pickle.load(f)
        enc = np.load(os.path.join(ckpt_dir, f"{tag}.enidx.npy"))
        dec = np.load(os.path.join(ckpt_dir, f"{tag}.deidx.npy"))
        return cls(cfg, params, enc, dec, adj_matrix, sc_matrix,
                   scaler=scaler, batch_size=batch_size, device=device)

    # ----------------------------------------------------------------- serve
    def _history(self, lags_a: torch.Tensor, lags_b: torch.Tensor, src: torch.Tensor):
        """The history at two lag sets: one spline kernel launch on the card."""
        return history_index_pair(lags_a, lags_b, src, self.his_span, interpolation="cubic")

    @torch.no_grad()
    def forward(self, src: torch.Tensor) -> torch.Tensor:
        """``src [B, N, his_len, 3]`` on the device -> ``[B, N, tgt_len]``."""
        y0, enc_in = self._history(self.dec_idx, self.enc_idx, src)
        sol, _ = ddeint(
            lambda y_lags, y: self.model(y_lags, y), y0, self.t_span, enc_in,
            src, self.his_span, self.cfg.solver, his_processed=True,
            fixed_solver_interp="", time_axis=0,
        )
        return sol[1][..., 0]

    def warmup(self):
        """Build the kernels and run one batch outside the serving path."""
        dummy = torch.zeros(
            (self.batch_size, self.cfg.num_nodes, self.cfg.his_len, 3), device=self.device
        )
        self.forward(dummy)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def _finish(self, outs):
        cfg = self.cfg
        preds = (
            np.concatenate(outs, axis=0)
            if outs
            else np.zeros((0, cfg.num_nodes, cfg.tgt_len), np.float32)
        )
        if self.scaler is not None:
            preds = self.scaler.inverse_transform(preds[..., None])[..., 0]
        return preds

    def predict_series(self, series: np.ndarray, starts) -> np.ndarray:
        """Bulk backtesting over a resident series: one upload, index batches.

        Args:
            series: the full transformed series ``[N, T, C]`` (scaled value +
                dow + tod channels).
            starts: window start indices ``[K]``; window ``k`` is
                ``series[:, starts[k] : starts[k] + his_len]``.

        Returns forecasts ``[K, N, tgt_len]``, equal to ``self(windows)`` on
        the host-gathered windows bit for bit. The device copy is cached by
        the identity of the passed array; pass a fresh array after mutating
        a series in place.
        """
        series = np.ascontiguousarray(series, np.float32)
        n, t, c = series.shape
        cfg = self.cfg
        if (n, c) != (cfg.num_nodes, 3):
            raise ValueError(
                f"series shape {series.shape} does not match the model's "
                f"({cfg.num_nodes}, *, 3)"
            )
        starts = np.asarray(starts, np.int64).reshape(-1)
        if starts.size and (starts.min() < 0 or starts.max() + cfg.his_len > t):
            raise ValueError(
                f"window starts [{starts.min()}, {starts.max()}] out of range "
                f"for his_len {cfg.his_len} over T={t}"
            )
        if self._series_src is not series or self._series_dev is None:
            self._series_dev = torch.as_tensor(series).to(self.device)
            self._series_src = series
        offsets = torch.arange(cfg.his_len, device=self.device)
        outs = []
        for lo in range(0, starts.size, self.batch_size):
            chunk = torch.as_tensor(starts[lo : lo + self.batch_size], device=self.device)
            windows = self._series_dev[:, chunk[:, None] + offsets]  # [N, b, his, C]
            outs.append(self.forward(windows.permute(1, 0, 2, 3).contiguous()).cpu().numpy())
        return self._finish(outs)

    def __call__(self, history: np.ndarray) -> np.ndarray:
        """``history [B, N, his_len, 3]`` (scaled value + dow + tod channels)
        -> forecasts ``[B, N, tgt_len]``."""
        history = np.asarray(history, np.float32)
        b, n, t, c = history.shape
        cfg = self.cfg
        if (n, t, c) != (cfg.num_nodes, cfg.his_len, 3):
            raise ValueError(
                f"history shape {history.shape} does not match the model's "
                f"(*, {cfg.num_nodes}, {cfg.his_len}, 3)"
            )
        outs = []
        for lo in range(0, b, self.batch_size):
            chunk = torch.as_tensor(np.ascontiguousarray(history[lo : lo + self.batch_size]))
            outs.append(self.forward(chunk.to(self.device)).cpu().numpy())
        return self._finish(outs)
