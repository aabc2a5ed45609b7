"""Training loop (counterpart of ``pointrcnn_tpu/train/trainer.py``).

Epochs over any iterable of numpy batch dicts (``set_epoch`` is called when
the loader has one), one train step per batch, BN momentum set per epoch,
checkpoints every ``ckpt_save_interval`` epochs, and loss-only validation
every ``eval_frequency`` epochs.  ``history`` keeps each epoch's record for
the caller: its steps, last loss, wall seconds, the wait for its first
batch and, where it ran, the validation loss.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from pointrcnn_tpu_torch.models.layers import set_bn_momentum
from pointrcnn_tpu_torch.train.checkpoint import save_checkpoint
from pointrcnn_tpu_torch.train.loss import model_loss
from pointrcnn_tpu_torch.train.optimizer import bn_momentum_for_epoch
from pointrcnn_tpu_torch.train.state import (
    TrainState,
    dropout_generator,
    make_train_step,
    target_generator,
)


def batch_to_device(batch: dict, device) -> dict:
    """The numeric numpy arrays of ``batch`` as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()
            if isinstance(v, np.ndarray) and v.dtype != object}


class Trainer:
    def __init__(self, cfg, tx, ckpt_dir: str, eval_frequency: int = 1,
                 ckpt_save_interval: int = 5, logger: logging.Logger | None = None,
                 seed: int = 0):
        self.cfg, self.ckpt_dir, self.seed = cfg, ckpt_dir, seed
        self.eval_frequency, self.ckpt_save_interval = eval_frequency, ckpt_save_interval
        self.logger = logger or logging.getLogger(__name__)
        self.train_step = make_train_step(cfg, tx, seed)
        self.history: list[dict] = []

    def train(self, state: TrainState, start_epoch: int, n_epochs: int, train_loader,
              val_loader=None, start_it: int = 0):
        """-> (state, iterations done)."""
        device = next(state.model.parameters()).device
        it = start_it
        os.makedirs(self.ckpt_dir, exist_ok=True)
        for epoch in range(start_epoch, n_epochs):
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            bn_momentum = bn_momentum_for_epoch(self.cfg, epoch)
            t0 = time.time()
            n_batches, tb, wait = 0, None, float("nan")
            for batch in train_loader:
                if n_batches == 0:
                    wait = time.time() - t0
                state, tb = self.train_step(state, batch_to_device(batch, device), bn_momentum)
                it += 1
                n_batches += 1
            dt = time.time() - t0
            loss = float(tb["loss"]) if tb is not None else float("nan")
            self.logger.info("epoch %d: %d its in %.1fs (%.2f it/s), last loss %.4f",
                             epoch, n_batches, dt, n_batches / max(dt, 1e-6), loss)
            self.history.append({"epoch": epoch, "steps": n_batches, "loss": loss,
                                 "seconds": dt, "wait": wait})
            trained_epoch = epoch + 1
            if trained_epoch % self.ckpt_save_interval == 0:
                path = save_checkpoint(self.ckpt_dir, state, trained_epoch, it)
                self.logger.info("saved checkpoint %s", path)
            if val_loader is not None and trained_epoch % self.eval_frequency == 0:
                val_loss = self.eval_epoch(state, val_loader)
                self.logger.info("epoch %d: val loss %.4f", epoch, val_loss)
                self.history[-1]["val_loss"] = val_loss
        return state, it

    def eval_epoch(self, state: TrainState, val_loader) -> float:
        """Loss-only validation: the training-mode forward (batch statistics,
        dropout and target draws from fixed streams) with BN momentum 0, so
        the running statistics stay as they are."""
        model = state.model
        device = next(model.parameters()).device
        set_bn_momentum(model, 0.0)
        model.train()
        total, count = 0.0, 0
        with torch.no_grad():
            for batch in val_loader:
                batch = batch_to_device(batch, device)
                out = model(batch, generator=dropout_generator(self.seed, 0, device),
                            target_generator=target_generator(self.seed, 0, device))
                total += float(model_loss(self.cfg, out, batch)[0])
                count += 1
        return total / max(count, 1)
