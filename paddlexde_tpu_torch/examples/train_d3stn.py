"""Train D3STN on a traffic-flow dataset (or a synthetic stand-in) with the port.

Counterpart of the JAX package's ``examples/train_d3stn.py:26-80`` (the
reference's ``example/D3STN/train_dde.py`` launch flow in
DrownFish19/PaddleXDE): the same flags and the same synthetic override set,
plus ``--device`` (the card by default) and ``--save_dir``. With a
reference ``configs/*.json`` and its PEMS/HZME npz + csv files in place it
runs the published recipe; ``--synthetic`` runs on generated data::

    python -m paddlexde_tpu_torch.examples.train_d3stn --config_json configs/PEMS08.json
    python -m paddlexde_tpu_torch.examples.train_d3stn --synthetic --train_epochs 5
    python -m paddlexde_tpu_torch.examples.train_d3stn --synthetic --device cpu

``--distribute`` (data parallelism) is not ported and raises.
"""

from __future__ import annotations

import argparse

import numpy as np

# the JAX CLI's synthetic configuration (SYNTH-like: 16 nodes, d_model 64,
# 4 heads, 2 + 2 layers)
SYNTHETIC = {
    "dataset_name": "SYNTH", "num_nodes": 16, "his_len": 288, "d_model": 64, "d_proj": 32,
    "d_sect": 16, "d_adaptive": 0, "encoder_num_layers": 2, "decoder_num_layers": 2,
    "head": 4, "top_k": 4, "warmup_step": 2, "decay_step": 8, "loss": "mae",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Traffic Flow Forecasting (PyTorch / CUDA)")
    p.add_argument("--config_json", type=str, default="")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--train_epochs", type=int, default=None)
    p.add_argument("--finetune_epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--distribute", action="store_true")
    p.add_argument("--seq_days", type=int, default=14, help="synthetic data length in days")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    p.add_argument("--save_dir", type=str, default=None,
                   help="checkpoint and log directory (default: the config's)")
    return p.parse_args(argv)


def setup(cli):
    """The config and the ``(data, adj, sc)`` (``None``: the config's files)
    that ``main`` trains on, from the parsed flags."""
    if cli.distribute:
        raise NotImplementedError(
            "--distribute (multi-device data parallelism) is not ported (ROADMAP.md, queue 1 "
            "item 10); the port trains on one card"
        )
    from paddlexde_tpu_torch.models.d3stn import load_config, synthetic_traffic_npz

    overrides = {k: v for k, v in vars(cli).items()
                 if k in ("train_epochs", "finetune_epochs", "batch_size", "save_dir")
                 and v is not None}
    if not cli.synthetic:
        return load_config(cli.config_json or None, **overrides), None, None, None
    for key, value in SYNTHETIC.items():
        overrides.setdefault(key, value)
    cfg = load_config(cli.config_json or None, **overrides)
    rng = np.random.RandomState(cfg.seed)
    data = synthetic_traffic_npz(cfg.num_nodes, seq_len=288 * cli.seq_days, seed=cfg.seed)
    adj = (rng.rand(cfg.num_nodes, cfg.num_nodes) < 0.3).astype(np.float32)
    adj = np.maximum(adj, adj.T)
    sc = rng.rand(cfg.num_nodes, cfg.num_nodes).astype(np.float32)
    return cfg, data, adj, sc


def main(argv=None) -> dict:
    """Train and test; returns the test metrics (``Trainer.train()``'s)."""
    from paddlexde_tpu_torch.models.d3stn import Trainer

    cli = parse_args(argv)
    cfg, data, adj, sc = setup(cli)
    trainer = Trainer(cfg, data=data, adj_matrix=adj, sc_matrix=sc, device=cli.device)
    results = trainer.train()
    print("final test:", {k: v for k, v in results.items() if k != "per_horizon"})
    return results


if __name__ == "__main__":
    main()
