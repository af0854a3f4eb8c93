"""D3STN configuration.

The port's own copy of ``paddlexde_tpu/models/d3stn/config.py``: the same
keys and defaults, so the reference-format ``configs/*.json`` files load
unchanged through :func:`load_config` (keys of the JAX package's own
implementation knobs -- ``conv_impl``, ``fuse_qkv``, ``remat``, ``spmd``,
``device_gather`` -- are not fields here and are dropped on load). The
``*_impl`` knobs keep the JAX package's vocabulary: ``"auto"`` runs a kernel
for CUDA tensors and the plain PyTorch version for CPU tensors, ``"xla"``
the plain version on any device, ``"pallas"`` the kernel (CUDA tensors
only).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

__all__ = ["D3STNConfig", "load_config"]


@dataclasses.dataclass
class D3STNConfig:
    # data
    dataset_name: str = "HZME_OUTFLOW"
    data_path: str = "TrafficFlowData/HZME_OUTFLOW/HZME_OUTFLOW.npz"
    adj_path: str = "TrafficFlowData/HZME_OUTFLOW/HZME_OUTFLOW.csv"
    sc_path: str = "TrafficFlowData/HZME_OUTFLOW/SCORR_HZME_OUTFLOW.npy"
    split: str = "6:2:2"
    scale: bool = True
    num_nodes: int = 80

    # model
    model_name: str = "D3STN"
    his_len: int = 288
    tgt_len: int = 12
    encoder_input_size: int = 1
    decoder_input_size: int = 1
    decoder_output_size: int = 1
    encoder_num_layers: int = 4
    decoder_num_layers: int = 4
    d_model: int = 128  # must equal d_proj + 2*d_sect + d_adaptive
    d_proj: int = 32
    d_sect: int = 32
    d_adaptive: int = 32
    attention: str = "Corr"  # "Corr" | "Vanilla"
    head: int = 8
    kernel_size: int = 3
    top_k: int = 5
    smooth_layer_num: int = 1
    with_adj: bool = True
    with_sc: bool = True
    solver: str = "euler"
    compute_dtype: str = "float32"  # "bfloat16": serving only (ROADMAP.md)
    gcn_impl: str = "auto"  # spatial-attention GCN: kernel K2 or plain
    attn_impl: str = "auto"  # temporal-context attention: kernel K4 or plain

    # train
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    start_epoch: int = 0
    train_epochs: int = 100
    warmup_step: int = 10
    decay_step: int = 30
    finetune_epochs: int = 50
    batch_size: int = 16
    patience: int = 15
    loss: str = "mse"  # "mae" | "mse" | "huber"
    kl_loss_weight: float = 1.0
    dropout: float = 0.0
    continue_training: bool = False
    finetune_fresh_schedule: bool = False
    distribute: bool = False
    seed: int = 0
    save_dir: str = "experiments"

    def __post_init__(self):
        expect = self.d_proj + 2 * self.d_sect + self.d_adaptive
        if self.d_model != expect:
            raise ValueError(
                f"d_model ({self.d_model}) must equal d_proj + 2*d_sect + "
                f"d_adaptive ({expect}) — the embedding concat feeds d_model"
            )
        for field, allowed in (
            ("gcn_impl", ("auto", "xla", "pallas")),
            ("attn_impl", ("auto", "xla", "pallas")),
            ("attention", ("Corr", "Vanilla")),
            ("compute_dtype", ("float32", "bfloat16")),
        ):
            val = getattr(self, field)
            if val not in allowed:
                raise ValueError(
                    f"{field}={val!r} not in {allowed} (a typo here would "
                    "silently fall back to a default implementation)"
                )


def load_config(json_path: Optional[str] = None, **overrides) -> D3STNConfig:
    """Build a config, optionally overriding from a reference-format JSON."""
    values = {}
    if json_path:
        with open(json_path) as f:
            values.update(json.load(f))
    values.update(overrides)
    known = {f.name for f in dataclasses.fields(D3STNConfig)}
    values = {k: v for k, v in values.items() if k in known}
    for key in ("scale", "with_adj", "with_sc", "continue_training", "distribute"):
        if key in values:
            values[key] = bool(values[key])
    return D3STNConfig(**values)
