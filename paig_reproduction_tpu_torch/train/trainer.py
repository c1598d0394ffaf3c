"""The training and evaluation loop.

Counterpart of ``paig_reproduction_tpu/train/trainer.py``: the save_dir
wipe, the pre-training valid eval, the epoch loop keyed on the train
iterator's epoch counter, ``print_interval`` train lines, an eval every
``eval_every_n_epochs`` epochs and a test-split eval at the end, with the
same log.txt lines. Every split lives on the device as uint8; each step
gathers its batch there from the iterator's indices.

Not ported yet: checkpoints and ``--use_ckpt``, the test-mode phase,
outputs.npz, visualizations, code.zip, the single-command recipes, the
watchdog and multi-device training.
"""
from __future__ import annotations

import logging
import os
import shutil
import sys
import time
from typing import Dict

import torch

from paig_reproduction_tpu_torch.data.iterators import gather_batch, to_device
from paig_reproduction_tpu_torch.models.physics_net import (
    PhysicsNet,
    compute_losses,
)
from paig_reproduction_tpu_torch.train import optimizers as opt_lib
from paig_reproduction_tpu_torch.utils.misc import log_metrics, use_full_f32

logger = logging.getLogger("paig")

EVAL_KEYS = ("eval_pred_loss", "eval_extrap_loss", "eval_recons_loss")


class Trainer:
    """Owns the model on its device, the optimizer and the device-resident
    data splits."""

    def __init__(self, model: PhysicsNet, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            use_full_f32()
        self.model = model.to(self.device)
        self.step = 0
        self.optimizer = None
        self._lr_at = None
        self._splits_u8: Dict[str, torch.Tensor] = {}

    # ----- data ------------------------------------------------------------
    def get_data(self, data_iterators):
        (self.train_iterator, self.valid_iterator,
         self.test_iterator) = data_iterators
        self._splits_u8 = {}

    def get_iterator(self, type):
        return {"train": self.train_iterator,
                "valid": self.valid_iterator,
                "test": self.test_iterator}[type]

    def _split_u8(self, type) -> torch.Tensor:
        if type not in self._splits_u8:
            self._splits_u8[type] = to_device(
                self.get_iterator(type).raw_uint8, self.device)
        return self._splits_u8[type]

    # ----- setup -----------------------------------------------------------
    def build_optimizer(self, base_lr, optimizer="rmsprop", anneal_lr=True,
                        epochs: int = 0, steps_per_epoch: int = 1):
        self._lr_at = opt_lib.lr_schedule(base_lr, epochs, steps_per_epoch,
                                          anneal_lr)
        self.optimizer = opt_lib.build_optimizer(
            optimizer, self.model.named_parameters(), base_lr)
        self.step = 0

    def initialize_graph(self, save_dir, use_ckpt=False, ckpt_dir=""):
        """save_dir semantics of a fresh run: an existing save_dir is WIPED
        and made anew."""
        if use_ckpt or ckpt_dir:
            raise NotImplementedError("checkpoints are not ported yet")
        self.save_dir = save_dir
        if os.path.exists(save_dir):
            logger.info("Folder exists, deleting...")
            shutil.rmtree(save_dir)
        os.makedirs(save_dir)

    def add_train_logger(self):
        log_path = os.path.abspath(os.path.join(self.save_dir, "log.txt"))
        for h in logger.handlers:
            if getattr(h, "baseFilename", None) == log_path:
                return
        fh = logging.FileHandler(log_path)
        fh.setFormatter(
            logging.Formatter("%(asctime)s - %(name)s - %(message)s"))
        logger.addHandler(fh)

    # ----- steps -------------------------------------------------------------
    def _losses(self, batch):
        out, aux = self.model(batch)
        return compute_losses(self.model, batch, out, aux["recons_out"])

    def train_step(self, idx) -> Dict[str, torch.Tensor]:
        """One optimizer step on the train-split sequences ``idx``.
        Returns the step's losses as device tensors."""
        batch = gather_batch(self._split_u8("train"), idx)
        for group in self.optimizer.param_groups:
            group["lr"] = self._lr_at(self.step)
        loss, eval_losses = self._losses(batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return dict(eval_losses, train_loss=loss.detach())

    # ----- loops -------------------------------------------------------------
    def train_model(self, epochs, batch_size, eval_every_n_epochs,
                    print_interval, debug=False):
        """Pre-train valid eval, per-epoch batch loop keyed on the
        iterator's epoch counter, periodic valid evals, final test eval."""
        self.add_train_logger()
        logger.info("\n".join(sys.argv))

        if not debug and epochs > 0:
            log_metrics(logger, "valid - epoch=%s" % 0,
                        self.eval_performance(batch_size, type="valid"))

        t0 = time.perf_counter()
        frames = 0
        for ep in range(1, epochs + 1):
            while self.train_iterator.epochs_completed < ep:
                step = self.step
                idx = self.train_iterator.next_index_batch(batch_size)
                metrics = self.train_step(idx)
                frames += len(idx) * self.model.seq_len
                if step % print_interval == 0:
                    log_metrics(logger, "train - iter=%s" % step,
                                {"train_loss": float(metrics["train_loss"])})
            if ep % eval_every_n_epochs == 0:
                print("eval running")
                log_metrics(logger, "valid - epoch=%s" % ep,
                            self.eval_performance(batch_size, type="valid"))

        if epochs > 0:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            logger.info("throughput: %.1f video frames/sec (%d frames, "
                        "%.1fs incl. eval)", frames / dt, frames, dt)

        test_metrics = self.eval_performance(batch_size, type="test")
        log_metrics(logger, "test - epoch=%s" % epochs, test_metrics)
        return test_metrics

    @torch.no_grad()
    def eval_performance(self, batch_size, type="valid"):
        """Whole-epoch metric averages over the split's batches; a split
        of fewer than 100 sequences is one batch."""
        eval_iterator = self.get_iterator(type)
        eval_iterator.reset_epoch()
        n = eval_iterator.X.shape[0]
        if n < 100:
            batch_size = n
        # Every index batch of one epoch (the ragged tail is dropped).
        idxs = eval_iterator.next_index_batches(batch_size, 10 ** 9)
        data_u8 = self._split_u8(type)
        per_batch = []
        for idx in idxs:
            _, eval_losses = self._losses(gather_batch(data_u8, idx))
            per_batch.append(torch.stack([eval_losses[k] for k in EVAL_KEYS]))
        means = torch.stack(per_batch).mean(dim=0).cpu().numpy()
        return {k: means[i] for i, k in enumerate(EVAL_KEYS)}
