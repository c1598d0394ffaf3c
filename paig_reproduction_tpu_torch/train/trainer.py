"""The training, evaluation and test loop.

Counterpart of ``paig_reproduction_tpu/train/trainer.py``: the save_dir
wipe or checkpoint restore, the pre-training valid eval, the epoch loop
keyed on the train iterator's epoch counter, ``print_interval`` train
lines, an eval every ``eval_every_n_epochs`` epochs, a checkpoint every
``save_every_n_epochs`` and once more after training, and a test-split eval
at the end, with the same log.txt lines and the same artifacts: code.zip,
model.ckpt, outputs.npz on every eval, and after every valid and test eval
``example%d.jpg``, ``animation%d.gif``, ``templates.jpg`` and
``extra_outputs.npz``. Every split lives on the device as uint8; each step
gathers its batch there from the iterator's indices.

Not ported yet: the single-command recipes, the watchdog, profiling and
multi-device training.
"""
from __future__ import annotations

import logging
import os
import shutil
import sys
import threading
import time
from typing import Dict

import numpy as np
import torch

from paig_reproduction_tpu_torch.data.iterators import gather_batch, to_device
from paig_reproduction_tpu_torch.models.physics_net import (
    PhysicsNet,
    compute_losses,
)
from paig_reproduction_tpu_torch.train import optimizers as opt_lib
from paig_reproduction_tpu_torch.train.checkpoint import (
    optimizer_state_by_name,
    restore_checkpoint,
    save_checkpoint,
)
from paig_reproduction_tpu_torch.utils.misc import (
    log_metrics,
    use_full_f32,
    zipdir,
)
from paig_reproduction_tpu_torch.utils.npz import savez_fast
from paig_reproduction_tpu_torch.utils.viz import gallery, gif, save_image

logger = logging.getLogger("paig")
# The tree code.zip snapshots: the repository root, named as the JAX
# trainer names it.
root_path = os.path.join(os.path.dirname(os.path.realpath(__file__)),
                         "..", "..")

EVAL_KEYS = ("eval_pred_loss", "eval_extrap_loss", "eval_recons_loss")


class Trainer:
    """Owns the model on its device, the optimizer, the device-resident
    data splits and the run's artifacts."""

    def __init__(self, model: PhysicsNet, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            use_full_f32()
        self.model = model.to(self.device)
        self.step = 0
        self.optimizer = None
        self._lr_at = None
        self._splits_u8: Dict[str, torch.Tensor] = {}
        # Epoch of train_model's loop, and the epochs of the checkpoint
        # chain this run resumed (0 for a fresh run); both go into every
        # checkpoint.
        self._cur_epoch = 0
        self._epoch_base = 0
        self._npz_thread = None

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

    # ----- checkpoint / save_dir semantics ----------------------------------
    def initialize_graph(self, save_dir, use_ckpt=False, ckpt_dir=""):
        """The JAX package's save_dir semantics: a fresh run WIPES an
        existing save_dir; ``use_ckpt`` restores from ``ckpt_dir``, or from
        ``save_dir`` when ``ckpt_dir`` is empty and save_dir exists. The
        restored step sets the LR schedule's position."""
        self.save_dir = save_dir
        restore, restore_dir = False, save_dir
        if os.path.exists(save_dir):
            if use_ckpt:
                restore = True
                restore_dir = ckpt_dir if ckpt_dir else save_dir
            else:
                logger.info("Folder exists, deleting...")
                shutil.rmtree(save_dir)
                os.makedirs(save_dir)
        else:
            os.makedirs(save_dir)
            if use_ckpt:
                restore = True
                restore_dir = ckpt_dir

        if restore:
            print(f"Loading model from: {restore_dir}/model.ckpt")
            scalars = restore_checkpoint(restore_dir, self.model,
                                         self.optimizer)
            self.step = scalars["step"]
            self._epoch_base = max(scalars["total_epochs_done"],
                                   scalars["epoch"])

    def save(self):
        save_checkpoint(self.save_dir, {
            "model": self.model.state_dict(),
            "optimizer": optimizer_state_by_name(self.model, self.optimizer),
            "step": self.step,
            "epoch": self._cur_epoch,
            "total_epochs_done": self._epoch_base + self._cur_epoch})

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
        return {**{k: v.detach() for k, v in eval_losses.items()},
                "train_loss": loss.detach()}

    # ----- loops -------------------------------------------------------------
    def train_model(self, epochs, batch_size, save_every_n_epochs,
                    eval_every_n_epochs, print_interval, debug=False):
        """Pre-train valid eval, per-epoch batch loop keyed on the
        iterator's epoch counter, periodic valid evals and saves, a final
        save, then the test eval."""
        self.batch_size = batch_size
        self.add_train_logger()
        zipdir(root_path, self.save_dir)
        logger.info("\n".join(sys.argv))

        if not debug and epochs > 0:
            log_metrics(logger, "valid - epoch=%s" % 0,
                        self.eval_performance(batch_size, type="valid"))

        t0 = time.perf_counter()
        frames = 0
        for ep in range(1, epochs + 1):
            self._cur_epoch = ep
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
            if ep % save_every_n_epochs == 0:
                print("saving")
                self.save()

        if epochs > 0:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            # After the clock: the test phase evaluates save_dir's
            # checkpoint, which must be the finished model.
            self.save()
            logger.info("throughput: %.1f video frames/sec (%d frames, "
                        "%.1fs incl. eval)", frames / dt, frames, dt)

        test_metrics = self.eval_performance(batch_size, type="test")
        log_metrics(logger, "test - epoch=%s" % epochs, test_metrics)
        self.flush_artifacts()
        return test_metrics

    def flush_artifacts(self):
        """Block until the outputs.npz writer (if any) has finished."""
        if self._npz_thread is not None:
            self._npz_thread.join()
            self._npz_thread = None

    @torch.no_grad()
    def eval_performance(self, batch_size, type="valid"):
        """Whole-epoch metric averages over the split's batches (a split of
        fewer than 100 sequences is one batch), the outputs.npz dump, then
        the visualization."""
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
        outputs = torch.stack(per_batch).cpu().numpy()   # [batches, 3]
        self._write_outputs_npz(eval_iterator.X[idxs.reshape(-1)], outputs)
        self.visualize_sequence()
        means = outputs.mean(axis=0)
        return {k: means[i] for i, k in enumerate(EVAL_KEYS)}

    def _write_outputs_npz(self, inputs, outputs):
        """outputs.npz (``input``: the split's evaluated sequences;
        ``output``: each batch's pred, extrap and recons losses), written
        by a non-daemon thread after any earlier one has finished."""
        self.flush_artifacts()
        path = os.path.join(self.save_dir, "outputs.npz")
        self._npz_thread = threading.Thread(
            target=savez_fast, args=(path,),
            kwargs=dict(input=inputs, output=outputs), daemon=False)
        self._npz_thread.start()

    # ----- visualization ------------------------------------------------------
    @torch.no_grad()
    def visualize_sequence(self):
        """The JAX package's visualization artifacts, from the model run on
        the next test batch of min(batch_size, $PAIG_VIZ_EXAMPLES=8)
        sequences: example%d.jpg (rows: prediction / ground truth /
        reconstruction), animation%d.gif (output over ground-truth strips),
        extra_outputs.npz and templates.jpg (sigmoid(contents) above
        sigmoid(template - 5))."""
        model = self.model
        batch_size = min(getattr(self, "batch_size", 8),
                         int(os.environ.get("PAIG_VIZ_EXAMPLES", "8")))
        batch_x, _ = self.test_iterator.next_batch(batch_size)
        # A split smaller than the batch gives fewer sequences.
        batch_size = batch_x.shape[0]
        output, aux = model(torch.from_numpy(batch_x).to(self.device),
                            with_extras=True)
        output_seq = output.cpu().numpy()
        recons_seq = aux["recons_out"].cpu().numpy()
        pos_vel_seq = aux["pos_vel_seq"].cpu().numpy()
        extras = {k: v.cpu().numpy() for k, v in aux["extras"].items()}

        for i in range(min(2, batch_size)):
            logger.info(pos_vel_seq[i])

        output_seq = np.concatenate(
            [batch_x[:, :model.input_steps], output_seq], axis=1)
        recons_seq = np.concatenate(
            [recons_seq,
             np.zeros((batch_size, model.extrap_steps)
                      + recons_seq.shape[2:])], axis=1)

        h = w = model.img_size
        for i in range(batch_x.shape[0]):
            total_seq = np.concatenate(
                [output_seq[i], batch_x[i], recons_seq[i]], axis=0)
            total_seq = np.transpose(total_seq, (0, 2, 3, 1))
            save_image(os.path.join(self.save_dir, "example%d.jpg" % i),
                       gallery(total_seq, ncols=batch_x.shape[1]))

        out_nhwc = np.transpose(output_seq, (0, 1, 3, 4, 2))
        gt_nhwc = np.transpose(batch_x, (0, 1, 3, 4, 2))
        if model.conv_ch == 1:
            out_nhwc = np.repeat(out_nhwc, 3, axis=-1)
            gt_nhwc = np.repeat(gt_nhwc, 3, axis=-1)
        bordered_out = 0.5 * np.ones(
            [batch_size, model.seq_len, h + 2, w + 2, 3])
        bordered_gt = 0.5 * np.ones_like(bordered_out)
        bordered_out[:, :, 1:-1, 1:-1] = out_nhwc
        bordered_gt[:, :, 1:-1, 1:-1] = gt_nhwc
        strip_out = np.concatenate(list(bordered_out), axis=-2)
        strip_gt = np.concatenate(list(bordered_gt), axis=-2)
        frames = np.concatenate([strip_out, strip_gt], axis=1)
        gif(os.path.join(self.save_dir,
                         "animation%d.gif" % (batch_x.shape[0] - 1)),
            frames * 255, fps=7, scale=3)

        np.savez_compressed(os.path.join(self.save_dir, "extra_outputs.npz"),
                            **extras)

        contents = np.transpose(extras["contents"], (0, 2, 3, 1))
        templates = np.transpose(extras["templates"], (0, 2, 3, 1))
        contents = 1 / (1 + np.exp(-contents))
        templates = 1 / (1 + np.exp(-(templates - 5)))
        if model.conv_ch == 1:
            contents = np.tile(contents, [1, 1, 1, 3])
        templates = np.tile(templates, [1, 1, 1, 3])
        save_image(os.path.join(self.save_dir, "templates.jpg"),
                   gallery(np.concatenate([contents, templates], axis=0),
                           ncols=model.n_objs))
