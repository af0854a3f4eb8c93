"""D3STN Trainer: two-phase delay-DE training on one CUDA card.

Counterpart of ``paddlexde_tpu/models/d3stn/trainer.py``, single process and
single card (the JAX Trainer's mesh and multi-process paths are not ported).
The full transformed series lives on the device and every step gathers its
windows from int start indices (the JAX ``device_gather`` path). One train
step at batch B:

    history_index_pair(dec_idx, enc_idx)
                            -> spline kernel, once (decoder input y0,
                                                    encoder input: the delay)
    ddeint(euler, t=[0, 1], his_processed=True)
                            -> D3STN once: 6 attention + 4 GCN forward kernels
    loss = criterion + kl_weight * (KL(delay) + KL(preds)), softmax over the
           horizon axis
    backward                -> 1 lag-gradient kernel (both lag sets), 4 GCN
                               and 6 attention backward kernel calls
    Adam (optax add_decayed_weights -> scale_by_adam: b1 0.9, b2 0.999,
    eps 1e-8) with a learning rate per group (net, lags) and epoch, the lags
    clipped to [0, his_len - 1], and the non-finite guard: when the loss,
    the new parameters or the new moments are not all finite, the old
    parameters, moments and step count are kept (device-side selects, no
    host sync) and the step reports a NaN loss.

The optimizer keeps its moments as two flat float32 vectors over the
parameters in ``state_names`` order, so the update and the guard are a few
device ops whatever the parameter count. The two-phase schedule (main phase:
net at ``learning_rate``, lags at 0.1x; finetune: the best checkpoint
reloaded, net at lr 0 with its moments still moving, lags at full rate),
eval, test metrics, early stopping, ``metrics.jsonl`` and the checkpoint
files follow the JAX Trainer. Checkpoints use its layout
(``epoch_*.params`` pickle of the flax tree, ``.enidx.npy``, ``.deidx.npy``),
so either package loads what the other wrote; the port's full-state sidecar
is ``epoch_*.params.torch_opt.npz`` (the JAX sidecar pickles optax objects
and is not read here).

With ``dropout > 0`` each train step draws the model's keep masks
(``model.DropoutMasks``) from the step seed ``numpy.random.SeedSequence(
(cfg.seed, epoch, step index))``; on the card the attention blocks run the
dropout forms of K4 and K5 and the GCN blocks the JAX model's XLA form (no
K2 or K3). Eval, test and ``predict_idx`` run the model in eval mode,
without dropout, as the JAX Trainer passes no rng there.
"""

from __future__ import annotations

import json
import os
import pickle
from contextlib import contextmanager
from time import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..._device import resolve_device
from ...functional.ddeint import ddeint
from ...xde.history import history_index_pair
from .config import D3STNConfig
from .dataset import TrafficFlowDataset
from .graph import get_adjacency_matrix_2direction, norm_adj_matrix
from .metrics import MAE, MAPE, RMSE, smis
from .model import D3STN
from .train_utils import EarlyStopping, Logger, cosine_annealing_with_warmup, kl_div
from .weights import load_flax_params, to_flax_params

__all__ = ["Trainer", "init_lag_anchors"]

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def init_lag_anchors(cfg: D3STNConfig):
    """Initial encoder/decoder lag positions (reference ``train_dde.py:126-175``):
    week / day / hour anchors depending on history length; decoder lags pinned
    to the last history point."""
    if cfg.his_len >= 2016:
        enc = np.arange(cfg.his_len - 2016, cfg.his_len - 2016 + 12)
    elif cfg.his_len >= 288:
        enc = np.arange(cfg.his_len - 288, cfg.his_len - 288 + 12)
    else:
        enc = np.arange(cfg.his_len - 12, cfg.his_len)
    dec = np.ones(cfg.tgt_len) * (cfg.his_len - 1)
    return enc.astype(np.float32), dec.astype(np.float32)


def _criterion(name: str):
    if name == "mae":
        return lambda pred, tgt: (pred - tgt).abs().mean()
    if name == "mse":
        return lambda pred, tgt: ((pred - tgt) ** 2).mean()
    if name == "huber":  # optax.huber_loss with delta 2
        return lambda pred, tgt: F.huber_loss(pred, tgt, reduction="mean", delta=2.0)
    raise NotImplementedError(f"loss {name} is not supported.")


class Trainer:
    """Orchestrates data, model, optimizer, two-phase schedule, eval/test.

    ``device``: CUDA by default (raises when there is none); ``"cpu"`` runs
    the plain PyTorch versions of the kernels. ``epoch_callback(epoch,
    trainer)`` fires after each epoch's eval; ``enc_idx_init`` /
    ``dec_idx_init`` override :func:`init_lag_anchors`. ``mesh`` is the JAX
    Trainer's multi-device argument and is refused. With
    ``compute_dtype="bfloat16"`` the model computes in bfloat16 (forward and
    backward, on the card through the bfloat16 kernels) while the
    parameters, the Adam moments, the loss, the lags and the non-finite
    guard stay float32, as in the JAX Trainer. ``dropout > 0`` trains with
    dropout in either dtype (module docstring).
    """

    def __init__(self, cfg: D3STNConfig, data: Optional[np.ndarray] = None,
                 adj_matrix: Optional[np.ndarray] = None,
                 sc_matrix: Optional[np.ndarray] = None,
                 mesh=None, epoch_callback=None, enc_idx_init=None,
                 dec_idx_init=None, *, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh / multi-process training is not ported (ROADMAP.md, queue 1 "
                "item 10); the port's Trainer runs on one card"
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        self.epoch_callback = epoch_callback
        self._enc_idx_init = enc_idx_init
        self._dec_idx_init = dec_idx_init
        self.save_path = os.path.join(
            cfg.save_dir, cfg.dataset_name,
            f"{cfg.loss}_{cfg.model_name}_elayer{cfg.encoder_num_layers}_"
            f"dlayer{cfg.decoder_num_layers}_head{cfg.head}_dm{cfg.d_model}_"
            f"lr{cfg.learning_rate}_bs{cfg.batch_size}_topk{cfg.top_k}_"
            f"att{cfg.attention}_dde",
        )
        os.makedirs(self.save_path, exist_ok=True)
        self.logger = Logger("D3STN", os.path.join(self.save_path, "log.txt"))
        self.early_stopping = EarlyStopping(patience=cfg.patience, delta=0.0)
        self.kl_loss_weight_init = cfg.kl_loss_weight
        self.kl_loss_weight = 0.0
        self.finetune = False
        self.metrics_history = []
        self._lr_cache = None

        self._build_data(data)
        self._build_model(adj_matrix, sc_matrix)
        self._build_optim(finetune=False)
        self.resume_epoch = None
        if cfg.continue_training:
            try:
                self.load()
                self._set_phase_lr(self.finetune)
            except FileNotFoundError:
                self.logger.warning("continue_training set but no checkpoint found")

    # ------------------------------------------------------------------ data
    def _build_data(self, data):
        cfg, dev = self.cfg, self.device
        self.train_dataset = TrafficFlowDataset(cfg, "train", data=data)
        self.val_dataset = TrafficFlowDataset(cfg, "val", data=data)
        self.test_dataset = TrafficFlowDataset(cfg, "test", data=data)
        enc, dec = init_lag_anchors(cfg)
        if self._enc_idx_init is not None:
            enc = np.asarray(self._enc_idx_init, np.float32)
        if self._dec_idx_init is not None:
            dec = np.asarray(self._dec_idx_init, np.float32)
        self.encoder_idx = torch.tensor(enc, device=dev, requires_grad=True)
        self.decoder_idx = torch.tensor(dec, device=dev, requires_grad=True)
        self.his_span = torch.arange(cfg.his_len, dtype=torch.float32, device=dev)
        # the solver reads its grid on the host
        self.t_span = torch.arange(2.0, dtype=torch.float32)
        # one upload of the full transformed series, shared by the splits
        self._series = torch.as_tensor(self.train_dataset.data).to(dev)
        self._offsets = torch.arange(cfg.his_len + cfg.tgt_len, device=dev)
        self.logger.info(f"encoder_idx: {enc}")
        self.logger.info(f"decoder_idx: {dec}")

    # ----------------------------------------------------------------- model
    def _build_model(self, adj_matrix, sc_matrix):
        cfg = self.cfg
        if adj_matrix is None:
            adj_matrix, _ = get_adjacency_matrix_2direction(cfg.adj_path, cfg.num_nodes)
        if sc_matrix is None:
            sc = np.load(cfg.sc_path)
            sc_matrix = sc[0] if sc.ndim == 3 else sc
        self.adj_matrix = norm_adj_matrix(np.asarray(adj_matrix)).astype(np.float32)
        self.sc_matrix = norm_adj_matrix(np.asarray(sc_matrix)).astype(np.float32)
        self.model = D3STN(cfg, self.adj_matrix, self.sc_matrix, device=self.device,
                           generator=torch.Generator().manual_seed(cfg.seed))
        self.model.train()
        n_params = sum(p.numel() for p in self.model.parameters())
        self.logger.info(f"Net's total params: {n_params}.")
        self.criterion = _criterion(cfg.loss)

    @property
    def state_names(self):
        """Names of the trained tensors, in the optimizer's flat order: the
        model's parameters, then ``enc_idx`` and ``dec_idx``."""
        return [n for n, _ in self.model.named_parameters()] + ["enc_idx", "dec_idx"]

    def state_tensors(self):
        """The trained tensors in ``state_names`` order (live, not copies)."""
        return list(self.model.parameters()) + [self.encoder_idx, self.decoder_idx]

    # ------------------------------------------------------------- optimizer
    def _build_optim(self, finetune: bool):
        cfg = self.cfg
        self.lr_schedule = cosine_annealing_with_warmup(
            max_lr=1.0, min_lr=0.1, warmup_step=cfg.warmup_step, decay_step=cfg.decay_step
        )
        self._set_phase_lr(finetune)
        self._sizes = [t.numel() for t in self.state_tensors()]
        total = sum(self._sizes)
        self.opt_state = {
            "count": torch.zeros((), dtype=torch.int32, device=self.device),
            "mu": torch.zeros(total, dtype=torch.float32, device=self.device),
            "nu": torch.zeros(total, dtype=torch.float32, device=self.device),
        }
        self.finetune = finetune

    def _set_phase_lr(self, finetune: bool):
        cfg = self.cfg
        if finetune:
            self.base_lr = {"net": 0.0, "lags": cfg.learning_rate}
        else:
            self.base_lr = {"net": cfg.learning_rate, "lags": cfg.learning_rate * 0.1}

    def _lr_vector(self, lr_net: float, lr_lags: float) -> torch.Tensor:
        """The per-element learning rate over the flat state (cached per pair)."""
        key = (float(lr_net), float(lr_lags))
        if self._lr_cache is None or self._lr_cache[0] != key:
            n_lags = self._sizes[-2] + self._sizes[-1]
            lr = torch.cat([torch.full((sum(self._sizes) - n_lags,), key[0]),
                            torch.full((n_lags,), key[1])]).to(self.device)
            self._lr_cache = (key, lr)
        return self._lr_cache[1]

    # ---------------------------------------------------------------- steps
    def _history(self, lags_a, lags_b, src):
        """The history at two lag sets: one spline kernel launch on the card."""
        return history_index_pair(lags_a, lags_b, src, self.his_span, interpolation="cubic")

    def _forward(self, src):
        """The delay-DE forward: reference ``train_one_step`` §3.4 call stack."""
        y0, y_lags = self._history(self.decoder_idx, self.encoder_idx, src)
        sol, delay = ddeint(
            lambda yl, y: self.model(yl, y), y0, self.t_span, y_lags, src, self.his_span,
            self.cfg.solver, his_processed=True, fixed_solver_interp="", time_axis=0,
        )
        return sol[1][..., :1], delay  # y after the single residual step, [B,N,T,1]

    def loss_fn(self, src, tgt, kl_weight):
        """``(total, loss, align)`` of the JAX Trainer's ``_loss_fn`` at the
        current parameters, differentiable."""
        preds, delay = self._forward(src)
        tgt_v = tgt[..., :1]
        loss = self.criterion(preds, tgt_v)
        tgt_softmax = torch.softmax(tgt_v, dim=-2)
        align = kl_div(torch.log_softmax(delay[..., :1], dim=-2), tgt_softmax)
        align = align + kl_div(torch.log_softmax(preds, dim=-2), tgt_softmax)
        return loss + kl_weight * align, loss, align

    def windows(self, starts):
        """``(src [B, N, his_len, 3], tgt [B, N, tgt_len, 3])`` gathered on the
        device from window starts (a device tensor, or host ints)."""
        his = self.cfg.his_len
        s = torch.as_tensor(starts, device=self.device).long()
        w = self._series[:, s[:, None] + self._offsets].permute(1, 0, 2, 3)
        return w[:, :, :his].contiguous(), w[:, :, his:].contiguous()

    def set_dropout_step(self, epoch: int, step: int) -> None:
        """Seed the model's dropout masks for the train step ``step`` of
        ``epoch`` (the JAX Trainer folds the same two numbers into its key);
        until the next call every step draws the same masks."""
        seed = np.random.SeedSequence((self.cfg.seed, epoch, step)).generate_state(1, np.uint64)
        self.model.dropout_masks.set_step(int(seed[0]))

    def train_step(self, src, tgt, kl_weight, lr_net, lr_lags):
        """One guarded Adam step on a batch; returns ``(loss, align)`` as
        device scalars (loss NaN when the step was skipped)."""
        state = self.state_tensors()
        total, loss, align = self.loss_fn(src, tgt, kl_weight)
        grads = torch.autograd.grad(total, state, materialize_grads=True)
        with torch.no_grad():
            loss = self._update(state, grads, total, loss, lr_net, lr_lags)
        return loss, align.detach()

    def train_step_idx(self, starts, kl_weight, lr_net, lr_lags):
        """:meth:`train_step` on the windows at ``starts``."""
        return self.train_step(*self.windows(starts), kl_weight, lr_net, lr_lags)

    def _update(self, state, grads, total, loss, lr_net, lr_lags):
        cfg, opt = self.cfg, self.opt_state
        p = torch.cat([t.detach().reshape(-1) for t in state])
        u = torch.cat([g.reshape(-1) for g in grads])
        if cfg.weight_decay:
            u = u + cfg.weight_decay * p
        count = opt["count"] + 1
        mu = (1 - ADAM_B1) * u + ADAM_B1 * opt["mu"]
        nu = (1 - ADAM_B2) * (u * u) + ADAM_B2 * opt["nu"]
        steps = count.to(torch.float32)
        mu_hat = mu / (1 - torch.pow(ADAM_B1, steps))
        nu_hat = nu / (1 - torch.pow(ADAM_B2, steps))
        new = p + -self._lr_vector(lr_net, lr_lags) * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS))
        # projected step: the learned lags stay inside the interpolation
        # domain [0, his_len-1] (the JAX Trainer's deliberate deviation from
        # the reference, which never clamps)
        n_lags = self._sizes[-2] + self._sizes[-1]
        new[-n_lags:] = new[-n_lags:].clamp(0.0, cfg.his_len - 1)
        ok = (torch.isfinite(total) & torch.isfinite(new).all() & torch.isfinite(mu).all()
              & torch.isfinite(nu).all())
        new = torch.where(ok, new, p)
        self.opt_state = {
            "count": torch.where(ok, count, opt["count"]),
            "mu": torch.where(ok, mu, opt["mu"]),
            "nu": torch.where(ok, nu, opt["nu"]),
        }
        torch._foreach_copy_(state, [v.view_as(t) for v, t in zip(new.split(self._sizes), state)])
        return torch.where(ok, loss.detach(), torch.full_like(loss, float("nan")))

    @contextmanager
    def _eval_mode(self):
        """The model in eval mode (no dropout) and no autograd, then back in
        training mode."""
        self.model.eval()
        try:
            with torch.no_grad():
                yield
        finally:
            self.model.train()

    def predict_idx(self, starts):
        """Forecasts ``[B, N, tgt_len, 1]`` (model space) for the windows at
        ``starts``."""
        with self._eval_mode():
            src, _ = self.windows(starts)
            return self._forward(src)[0]

    def _device_starts(self, batches):
        """Window-start batches as device tensors, in one upload."""
        if not batches:
            return []
        flat = torch.as_tensor(np.concatenate(batches).astype(np.int64), device=self.device)
        return flat.split([len(b) for b in batches])

    # ------------------------------------------------------------ train loop
    def train(self):
        cfg = self.cfg
        self.logger.info("start train...")
        best_eval_loss, best_epoch = np.inf, 0
        epoch = cfg.start_epoch
        if self.resume_epoch:
            epoch = self.resume_epoch
            self.logger.info(f"resuming from epoch {epoch}")
        s_time = time()

        while epoch < cfg.train_epochs + cfg.finetune_epochs:
            if epoch == cfg.train_epochs:
                self._init_finetune()
            if epoch == cfg.warmup_step:
                self.kl_loss_weight = self.kl_loss_weight_init

            sched_epoch = (
                epoch - cfg.train_epochs
                if self.finetune and cfg.finetune_fresh_schedule
                else epoch
            )
            lr_factor = self.lr_schedule(sched_epoch + 1)
            lr_net = self.base_lr["net"] * lr_factor
            lr_lags = self.base_lr["lags"] * lr_factor

            tr_s = time()
            batches = list(self.train_dataset.batch_starts(
                cfg.batch_size, shuffle=True, seed=cfg.seed + epoch, drop_last=True))
            # the per-batch losses stay on the device until the epoch ends: a
            # host read per step would hold the next step's launches behind it
            losses = []
            for i, s_b in enumerate(self._device_starts(batches)):
                self.set_dropout_step(epoch, i)
                losses.append(self.train_step_idx(s_b, self.kl_loss_weight, lr_net, lr_lags)[0])
            n_batches = len(losses)
            if losses:
                arr = torch.stack(losses).cpu().numpy()
                finite = np.isfinite(arr)
                n_skip = int(np.sum(~finite))
                epoch_loss = float(np.where(finite, arr, 0.0).sum())
                if n_skip:
                    self.logger.warning(
                        f"epoch {epoch}: skipped {n_skip}/{n_batches} "
                        "non-finite train step(s) (state kept)"
                    )
                n_batches = max(n_batches - n_skip, 1)
            else:
                epoch_loss = 0.0
            self.logger.info(
                f"epoch: {epoch}, lr {lr_net:.2e}/{lr_lags:.2e}, train loss "
                f"{epoch_loss / max(n_batches, 1):.6f}, time {time() - tr_s:.1f}s "
                f"(total {time() - s_time:.1f}s)"
            )
            self._write_scalars(
                epoch,
                {"train/loss": epoch_loss / max(n_batches, 1),
                 "train/lr_net": lr_net, "train/lr_lags": lr_lags,
                 "train/kl_weight": self.kl_loss_weight},
            )

            eval_loss = self.compute_eval_loss(epoch)
            self._write_scalars(epoch, {"eval/loss": eval_loss})
            if eval_loss < best_eval_loss:
                best_eval_loss, best_epoch = eval_loss, epoch
                self.logger.info(f"best_epoch: {best_epoch}, eval_loss: {eval_loss}")
                self.save(epoch=epoch, full_state=True)
                self.save(full_state=True, at_epoch=epoch)

            if self.epoch_callback is not None:
                self.epoch_callback(epoch, self)

            self.early_stopping(eval_loss)
            if self.early_stopping.early_stop:
                self.logger.info("Early stopping")
                if epoch < cfg.train_epochs:
                    epoch = cfg.train_epochs
                    continue
                break
            epoch += 1

        self.logger.info(f"best epoch: {best_epoch}")
        self.load()
        return self.compute_test_loss()

    def _init_finetune(self):
        self.logger.info("Start FineTune Training")
        try:
            self.load()
        except FileNotFoundError:
            pass
        self.early_stopping.reset()
        self._build_optim(finetune=True)

    # ------------------------------------------------------------ eval/test
    def compute_eval_loss(self, epoch=-1) -> float:
        """Mean eval loss over the validation windows."""
        batches = list(self.val_dataset.batch_starts(self.cfg.batch_size))
        with self._eval_mode():
            dev_losses = [self.criterion(*self._eval_pair(s_b))
                          for s_b in self._device_starts(batches)]
        losses = torch.stack(dev_losses).cpu().numpy().astype(np.float64) if dev_losses else []
        eval_loss = float(np.mean(losses)) if len(losses) else np.inf
        self.logger.info(f"epoch {epoch} eval_loss: {eval_loss:.6f}")
        return eval_loss

    def _eval_pair(self, starts):
        src, tgt = self.windows(starts)
        return self._forward(src)[0], tgt[..., :1]

    def compute_test_loss(self, epoch=-1) -> dict:
        """Test metrics (per horizon and overall) over the inverse-transformed
        forecasts (reference ``train_dde.py:635-649``)."""
        ds = self.test_dataset
        his, tgt_len = self.cfg.his_len, self.cfg.tgt_len
        batches = list(ds.batch_starts(self.cfg.batch_size))
        preds = [self.predict_idx(s_b).cpu().numpy() for s_b in self._device_starts(batches)]
        trues = [np.stack([ds.data[:, s + his : s + his + tgt_len, :1] for s in s_b], 0)
                 for s_b in batches]
        preds = ds.inverse_transform(np.concatenate(preds, 0))
        trues = ds.inverse_transform(np.concatenate(trues, 0))

        results = {"per_horizon": []}
        for i in range(trues.shape[2]):
            mae = MAE(trues[:, :, i, 0], preds[:, :, i, 0])
            rmse = RMSE(trues[:, :, i, 0], preds[:, :, i, 0])
            mape = MAPE(trues[:, :, i, 0], preds[:, :, i, 0], 0.9)
            results["per_horizon"].append({"mae": mae, "rmse": rmse, "mape": mape})
            self.logger.info(f"{i} MAE: {mae:.4f} RMSE: {rmse:.4f} MAPE: {mape:.4f}")
        results["mae"] = MAE(trues.reshape(-1, 1), preds.reshape(-1, 1))
        results["rmse"] = RMSE(trues.reshape(-1, 1), preds.reshape(-1, 1))
        results["mape"] = MAPE(trues.reshape(-1, 1), preds.reshape(-1, 1), 0.9)
        results["smis"] = smis(
            trues.reshape(trues.shape[0], -1), preds.reshape(preds.shape[0], -1),
            m=288, level=0.95,
        )
        self.logger.info(
            f"all MAE: {results['mae']:.4f} RMSE: {results['rmse']:.4f} "
            f"MAPE: {results['mape']:.4f} sMIS: {results['smis']:.4f}"
        )
        self.metrics_history.append(results)
        return results

    def _write_scalars(self, step, scalars: dict):
        """Append scalars to metrics.jsonl (the reference's VisualDL scalar
        stream, ``train_dde.py:369-371``, as plain JSON lines)."""
        with open(os.path.join(self.save_path, "metrics.jsonl"), "a") as f:
            f.write(json.dumps({"step": step, **{k: float(v) for k, v in scalars.items()}}) + "\n")

    # ----------------------------------------------------------- checkpoints
    def _ckpt_files(self, epoch=None):
        tag = f"epoch_{epoch}" if epoch is not None else "epoch_best"
        return (
            os.path.join(self.save_path, f"{tag}.params"),
            os.path.join(self.save_path, f"{tag}.enidx"),
            os.path.join(self.save_path, f"{tag}.deidx"),
        )

    def save(self, epoch=None, full_state: bool = False, at_epoch=None):
        """Persist params + lag tensors in the JAX Trainer's file-per-part
        layout (reference ``train_dde.py:306-321``); ``full_state`` also
        writes the optimizer moments, step count, phase, KL weight and epoch
        to ``<params>.torch_opt.npz`` for an exact resume. ``at_epoch``
        records the epoch when the filename tag is epoch-less
        (``epoch_best``)."""
        pf, ef, df = self._ckpt_files(epoch)
        with open(pf, "wb") as f:
            pickle.dump(to_flax_params(self.model), f)
        np.save(ef + ".npy", self.encoder_idx.detach().cpu().numpy())
        np.save(df + ".npy", self.decoder_idx.detach().cpu().numpy())
        if full_state:
            saved_epoch = epoch if epoch is not None else at_epoch
            np.savez(
                pf + ".torch_opt.npz",
                names=np.asarray(self.state_names), sizes=np.asarray(self._sizes),
                count=self.opt_state["count"].cpu().numpy(),
                mu=self.opt_state["mu"].cpu().numpy(), nu=self.opt_state["nu"].cpu().numpy(),
                finetune=self.finetune, kl_loss_weight=self.kl_loss_weight,
                epoch=-1 if saved_epoch is None else saved_epoch,
            )
        self.logger.info(f"save parameters to file: {pf}")

    def load(self, epoch=None):
        """Load ``epoch_best`` (or ``epoch``) written by either package; the
        port's full-state sidecar, where present, restores the optimizer.
        The params file is a pickle: load only checkpoints this project's
        trainers wrote."""
        pf, ef, df = self._ckpt_files(epoch)
        if not os.path.exists(pf):
            raise FileNotFoundError(pf)
        with open(pf, "rb") as f:
            load_flax_params(self.model, pickle.load(f))
        with torch.no_grad():
            self.encoder_idx.copy_(torch.as_tensor(np.load(ef + ".npy")))
            self.decoder_idx.copy_(torch.as_tensor(np.load(df + ".npy")))
        sidecar = pf + ".torch_opt.npz"
        if os.path.exists(sidecar):
            with np.load(sidecar) as extra:
                if list(extra["names"]) != self.state_names or list(extra["sizes"]) != self._sizes:
                    raise ValueError(f"{sidecar} does not match the model's parameters")
                self.opt_state = {
                    "count": torch.as_tensor(extra["count"]).to(self.device),
                    "mu": torch.as_tensor(extra["mu"]).to(self.device),
                    "nu": torch.as_tensor(extra["nu"]).to(self.device),
                }
                self.finetune = bool(extra["finetune"])
                self.kl_loss_weight = float(extra["kl_loss_weight"])
                if int(extra["epoch"]) >= 0:
                    self.resume_epoch = int(extra["epoch"]) + 1
        elif os.path.exists(pf + ".opt"):
            self.logger.warning(
                f"{pf}.opt holds the JAX package's optimizer state, which the port "
                "does not read: parameters and lags loaded, Adam moments kept"
            )
        self.logger.info(f"load weight from: {pf}")
