"""Adjacency loading and normalisation.

The port's own copy of ``paddlexde_tpu/models/d3stn/graph.py`` (numpy
only): CSV edge lists (optionally 2-direction, optionally id-remapped) or
``.npy`` matrices, plus row-normalised / symmetric-normalised forms.
"""

from __future__ import annotations

import csv
import os
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "get_adjacency_matrix",
    "get_adjacency_matrix_2direction",
    "norm_adj_matrix",
    "sym_norm_adj",
    "multichannel_norm_adj",
]


def _read_edges(path: str, n: int, id_filename: Optional[str], bidirectional: bool):
    a = np.zeros((n, n), np.float32)
    dist = np.zeros((n, n), np.float32)
    id_map = None
    if id_filename:
        with open(id_filename) as f:
            id_map = {int(i): idx for idx, i in enumerate(f.read().strip().split("\n"))}
    with open(path) as f:
        f.readline()  # header
        for row in csv.reader(f):
            if len(row) != 3:
                continue
            i, j, d = int(row[0]), int(row[1]), float(row[2])
            if id_map is not None:
                i, j = id_map[i], id_map[j]
            a[i, j] = 1
            dist[i, j] = d
            if bidirectional:
                a[j, i] = 1
                dist[j, i] = d
    return a, dist


def get_adjacency_matrix(path: str, num_nodes: int, id_filename=None) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    if path.endswith(".npy") or "npy" in os.path.basename(path):
        return np.load(path), None
    return _read_edges(path, int(num_nodes), id_filename, bidirectional=False)


def get_adjacency_matrix_2direction(path: str, num_nodes: int, id_filename=None):
    if path.endswith(".npy") or "npy" in os.path.basename(path):
        return np.load(path), None
    return _read_edges(path, int(num_nodes), id_filename, bidirectional=True)


def norm_adj_matrix(w: np.ndarray) -> np.ndarray:
    """Row-normalised (D^-1)(A + I)."""
    if w.shape[0] != w.shape[1]:
        raise ValueError(f"adjacency must be square, got {w.shape}")
    w = w + np.identity(w.shape[0], w.dtype)
    d_inv = np.diag(1.0 / np.sum(w, axis=1))
    return d_inv @ w


def sym_norm_adj(w: np.ndarray) -> np.ndarray:
    """Symmetric-normalised form with the reference's exact arithmetic (it
    multiplies by sqrt(D), not D^-1/2; it only feeds relative edge weights)."""
    if w.shape[0] != w.shape[1]:
        raise ValueError(f"adjacency must be square, got {w.shape}")
    w = w + np.identity(w.shape[0], w.dtype)
    d_sqrt = np.sqrt(np.diag(np.sum(w, axis=1)))
    return d_sqrt @ w @ d_sqrt


def multichannel_norm_adj(a: np.ndarray) -> np.ndarray:
    return np.stack([norm_adj_matrix(a[c]) for c in range(a.shape[0])])
