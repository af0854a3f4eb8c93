"""Traffic-flow dataset pipeline (numpy host-side, device-fed batches).

The port's own copy of ``paddlexde_tpu/models/d3stn/dataset.py``: the same
split, scaling, windows, HZME filter and batch order. ``batches`` copies
windows with numpy (the JAX package's OpenMP gather, ``ops/native``, is
host-side code for the multi-process path, not ported yet); the port's
Trainer keeps the series on the device and uses ``batch_starts``.

Rebuild of ``example/D3STN/dataset.py`` (DrownFish19/PaddleXDE): npz
``[T, N, D] -> [N, T, D]`` with only the value channel kept, ratio split
(train-fit ScalerMinMax to [-1, 1] with min forced to 0,
``dataset.py:76-97``), appended day-of-week / time-of-day index channels
(288 slots/day), sliding (his, tgt) window pairs, and the HZME
operating-hours filter (skip windows whose target falls in the first 6 closed
hours of the day, ``dataset.py:190-193``).
"""

from __future__ import annotations

import numpy as np
import torch

from .config import D3STNConfig

__all__ = ["ScalerStd", "ScalerMinMax", "TrafficFlowDataset", "synthetic_traffic_npz"]


class ScalerStd:
    """Mean/std normalization (reference ``dataset.py:6-55``)."""

    def __init__(self):
        self.mean, self.std = 0.0, 1.0

    def fit(self, data):
        self.mean, self.std = float(np.mean(data)), float(np.std(data))

    def transform(self, data):
        return (data - self.mean) / self.std

    def inverse_transform(self, data):
        return data * self.std + self.mean


class ScalerMinMax:
    """Min-max to [-1, 1] with min forced to zero (reference
    ``dataset.py:58-112``) — per-node when fit with axis."""

    def __init__(self):
        self.min, self.max = 0.0, 1.0

    def fit(self, data, axis=None):
        self.min = np.min(data) if axis is None else np.min(data, axis=axis, keepdims=True)
        self.min = self.min * 0.0  # min must be zero (reference contract)
        self.max = np.max(data) if axis is None else np.max(data, axis=axis, keepdims=True)

    def transform(self, data):
        data = 1.0 * (data - self.min) / (self.max - self.min)
        return 2.0 * data - 1.0

    def inverse_transform(self, data):
        _min, _max = self.min, self.max
        if isinstance(data, torch.Tensor):  # a tensor stays on its device
            _min = torch.as_tensor(_min, dtype=data.dtype, device=data.device)
            _max = torch.as_tensor(_max, dtype=data.dtype, device=data.device)
        return ((data + 1.0) / 2.0) * (_max - _min) + _min


class TrafficFlowDataset:
    """Window-pair dataset with reference-identical split/window semantics."""

    def __init__(self, cfg: D3STNConfig, data_type: str = "train", data=None):
        self.cfg = cfg
        if data is None:
            data = np.load(cfg.data_path)["data"]
        origin = np.asarray(data).transpose(1, 0, 2)[:, :, :1]  # [N, T, 1]
        self.num_nodes, self.seq_len, _ = origin.shape

        ratios = np.asarray([int(r) for r in cfg.split.split(":")], np.float64)
        ratios = ratios / ratios.sum()
        self.train_size = int(self.seq_len * ratios[0])
        self.val_size = int(self.seq_len * ratios[1])
        self.test_size = int(self.seq_len * ratios[2])
        self.data_type = data_type

        if cfg.scale:
            self.scaler = ScalerMinMax()
            self.scaler.fit(origin[:, : self.train_size, :], axis=1)
            scaled = self.scaler.transform(origin)
        else:
            self.scaler = None
            scaled = origin

        index = np.arange(self.seq_len).reshape(1, -1, 1).repeat(self.num_nodes, 0)
        dow = (index // 288) % 7
        tod = index % 288
        self.data = np.concatenate([scaled, dow, tod], axis=-1).astype(np.float32)

        if data_type == "train":
            data_len, offset = self.train_size - cfg.tgt_len, 0
        elif data_type == "val":
            data_len, offset = self.val_size - cfg.tgt_len, self.train_size - cfg.his_len
        else:
            data_len, offset = (
                self.test_size - cfg.tgt_len,
                self.train_size + self.val_size - cfg.his_len,
            )

        self.windows = []
        for i in range(max(data_len, 0)):
            his_begin = i + offset
            his_end = his_begin + cfg.his_len
            tgt_begin, tgt_end = his_end, his_end + cfg.tgt_len
            if his_begin < 0 or tgt_end > self.seq_len:
                continue
            if "HZME" in cfg.dataset_name and (
                tgt_begin % 288 < 72 or tgt_end % 288 < 72
            ):
                continue
            self.windows.append((his_begin, his_end, tgt_begin, tgt_end))

    def __len__(self):
        return len(self.windows)

    def __getitem__(self, index):
        hb, he, tb, te = self.windows[index]
        return self.data[:, hb:he, :], self.data[:, tb:te, :]

    def inverse_transform(self, data):
        return self.scaler.inverse_transform(data) if self.scaler else data

    def _epoch_order(self, shuffle, seed, process_index, process_count):
        """Sample order for one epoch: shared-seed shuffle, then a wrap-padded
        strided per-process shard (the reference DistributedBatchSampler
        semantics — see :meth:`batches`)."""
        order = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        if process_count > 1:
            total = -(-len(order) // process_count) * process_count
            if total > len(order) and len(order) > 0:
                order = np.concatenate([order, order[: total - len(order)]])
            order = order[process_index::process_count]
        return order

    def batch_starts(self, batch_size, shuffle=False, seed=0, drop_last=False,
                     process_index=0, process_count=1):
        """Yield int32 window-START batches for the device-resident-series
        path (``Trainer`` with ``device_gather``): every window is the
        contiguous slice ``[start, start+his_len+tgt_len)`` of the full
        transformed series, so a start index fully determines the (his, tgt)
        pair — the jitted step dynamic-slices them on device and the host
        ships 4 bytes per sample instead of the ~4 MB window. Order/shard/
        HZME-filter semantics are exactly :meth:`batches`'s (same
        ``_epoch_order``, same ``self.windows``)."""
        starts = np.asarray([w[0] for w in self.windows], np.int32)
        order = self._epoch_order(shuffle, seed, process_index, process_count)
        for s in range(0, len(order), batch_size):
            idx = order[s : s + batch_size]
            if drop_last and idx.size < batch_size:
                return
            yield starts[idx]

    def batches(self, batch_size, shuffle=False, seed=0, drop_last=False,
                time_major=False, process_index=0, process_count=1):
        """Yield (his, tgt) numpy batches.

        Both layouts fill REUSED preallocated buffers with ``np.copyto``
        (fresh per-batch allocations page-fault). Default layout is the
        model's ``[B, N, T, 3]``;
        ``time_major=True`` yields ``[B, T, N, 3]`` (contiguous source slices;
        transpose on device if needed). The consumer MUST snapshot/upload each
        batch before advancing the iterator (``utils.data.prefetch`` does;
        plain ``np.asarray``/``torch.as_tensor`` alias and do not).

        ``process_index``/``process_count`` give each host a disjoint strided
        shard of the (shared-seed) global order — the role of the reference's
        ``DistributedBatchSampler`` (``example/D3STN/train_dde.py:99-114`` in
        DrownFish19/PaddleXDE). Like the reference sampler, the order is
        wrap-padded so every process yields the SAME number of samples (a few
        duplicates at the tail instead of a collective-deadlocking ragged
        epoch); the shuffle seed must match across processes.
        """
        cfg = self.cfg
        starts = np.asarray([w[0] for w in self.windows])
        order = self._epoch_order(shuffle, seed, process_index, process_count)

        n, d = self.data.shape[0], self.data.shape[2]
        if time_major:
            if not hasattr(self, "_data_tmajor"):
                self._data_tmajor = np.ascontiguousarray(self.data.transpose(1, 0, 2))
            his_buf = np.empty((batch_size, cfg.his_len, n, d), self.data.dtype)
            tgt_buf = np.empty((batch_size, cfg.tgt_len, n, d), self.data.dtype)
        else:
            his_buf = np.empty((batch_size, n, cfg.his_len, d), self.data.dtype)
            tgt_buf = np.empty((batch_size, n, cfg.tgt_len, d), self.data.dtype)

        for start in range(0, len(order), batch_size):
            idx = order[start : start + batch_size]
            if drop_last and idx.size < batch_size:
                return
            b = idx.size
            for i, j in enumerate(idx):
                s = starts[j]
                e = s + cfg.his_len
                if time_major:
                    np.copyto(his_buf[i], self._data_tmajor[s:e])
                    np.copyto(tgt_buf[i], self._data_tmajor[e : e + cfg.tgt_len])
                else:
                    np.copyto(his_buf[i], self.data[:, s:e, :])
                    np.copyto(tgt_buf[i], self.data[:, e : e + cfg.tgt_len, :])
            yield his_buf[:b], tgt_buf[:b]


def synthetic_traffic_npz(num_nodes=16, seq_len=288 * 14, seed=0):
    """Small synthetic dataset in the reference npz layout [T, N, D] — daily +
    weekly periodic flows with node-correlated noise; used by tests and smoke
    runs (the real PEMS/HZME npz files are not distributable)."""
    rng = np.random.RandomState(seed)
    t = np.arange(seq_len)
    daily = 100 + 80 * np.sin(2 * np.pi * t / 288)[:, None]
    weekly = 20 * np.sin(2 * np.pi * t / (288 * 7))[:, None]
    base = daily + weekly
    mixing = rng.rand(num_nodes, num_nodes)
    mixing /= mixing.sum(1, keepdims=True)
    node_noise = rng.randn(seq_len, num_nodes) @ mixing.T * 5
    data = np.clip(base + node_noise + rng.rand(1, num_nodes) * 30, 0, None)
    return data[..., None].astype(np.float32)  # [T, N, 1]
