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

The single-command recipes (``train/recipes.py``) hook into the loop as in
the JAX trainer: the aux-loss warm-up and the ``--aux_on_recons`` trigger,
train-time physics self-identification every ``fit_physics_every`` epochs,
the ``--auto_rescue`` surgery after a stalled valid eval, and
``--enhancers_eval_only`` (the train step runs a copy of the model without
the inference enhancers, sharing its parameters; evals keep them). The
recipe state goes into every checkpoint and comes back on restore.

The runtime extras, as in the JAX trainer: the hung-device watchdog
(``watchdog_secs``, ``watchdog_floor_secs``; ``train/watchdog.py``), armed at
the first batch, petted once per train and eval batch and stopped before the
run's last artifacts; a ``torch.profiler`` trace of ``train_model``'s
training part (``profile_dir``: a Chrome trace that TensorBoard also reads,
where the JAX trainer writes a ``jax.profiler`` one); and ``debug_nans``,
the counterpart of ``jax_debug_nans``: a ``FloatingPointError`` at the first
forward whose outputs or losses hold a NaN, or the first backward (autograd's
anomaly mode with its NaN check) or gradient that does.

Not ported yet: multi-device training.
"""
from __future__ import annotations

import contextlib
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
    recipe_state,
    restore_checkpoint,
    save_checkpoint,
)
from paig_reproduction_tpu_torch.train.recipes import RecipeMixin
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


class Trainer(RecipeMixin):
    """Owns the model on its device, the optimizer, the device-resident
    data splits, the recipe state and the run's artifacts. ``seed`` seeds
    the discovery arms' weights; ``enhancers_eval_only`` trains without the
    inference enhancers."""

    def __init__(self, model: PhysicsNet, device="cuda", seed: int = 0,
                 enhancers_eval_only: bool = False, profile_dir: str = ""):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            use_full_f32()
        self.model = model.to(self.device)
        self.seed = seed
        # The model the train step runs: the model itself, or its copy
        # without the enhancers, sharing every parameter.
        self.train_net = (self.model.without_enhancers()
                          if enhancers_eval_only else self.model)
        self.step = 0
        self.optimizer = None
        self._lr_at = None
        # Step at which the optimizer (and its LR schedule) started.
        self._opt_step0 = 0
        self._splits_u8: Dict[str, torch.Tensor] = {}
        # Epoch of train_model's loop, and the epochs of the checkpoint
        # chain this run resumed (0 for a fresh run); both go into every
        # checkpoint.
        self._cur_epoch = 0
        self._epoch_base = 0
        self._npz_thread = None
        # Recipes (train/recipes.py). Steps before the extension losses
        # count (--aux_warmup_epochs; NEVER until --aux_on_recons fires).
        self.aux_warmup_steps = 0
        self.aux_on_recons = 0.0
        self._aux_triggered = False
        self.fit_physics_every = 0
        self.fit_physics_after = 0
        self.auto_rescue = 0
        self.rescue_recons = 3.0
        self.rescue_disk_radius = 0.0
        self.rescue_seed_color = False
        self.max_rescues = 1
        self._rescue_count = 0
        self._last_rescue_ep = -(10 ** 9)
        self._rescue_step = -1
        # (epoch, valid recons) of every valid eval: the rescue's stall
        # guard.
        self._recons_history = []
        # Epochs the discovery arms used before train_model's loop.
        self._epochs_consumed = 0
        # Runtime extras (module docstring). The watchdog is made at the
        # first pet, so a trainer with watchdog_secs=0 starts no thread.
        self.profile_dir = profile_dir
        self.watchdog_secs = 0.0
        self.watchdog_floor_secs = 0.0
        self._watchdog = None
        self.debug_nans = False

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
                        epochs: int = 0, steps_per_epoch: int = 1,
                        physics_lr_mult: float = 1.0,
                        grad_clip: float = 0.0, aux_warmup_epochs: int = 0,
                        bg_lr_mult: float = 1.0):
        self.base_lr = base_lr
        self.anneal_lr = anneal_lr
        self.aux_warmup_steps = aux_warmup_epochs * steps_per_epoch
        self._opt_args = dict(optimizer=optimizer, epochs=epochs,
                              steps_per_epoch=steps_per_epoch,
                              physics_lr_mult=physics_lr_mult,
                              grad_clip=grad_clip, bg_lr_mult=bg_lr_mult)
        self.optimizer = self._make_optimizer()
        self.step = self._opt_step0 = 0

    def _make_optimizer(self, epochs=None, bg_lr_mult=None):
        """A fresh optimizer with build_optimizer's arguments, and its LR
        schedule over ``epochs`` (build_optimizer's by default)."""
        a = self._opt_args
        self._lr_at = opt_lib.lr_schedule(
            self.base_lr, a["epochs"] if epochs is None else epochs,
            a["steps_per_epoch"], self.anneal_lr)
        return opt_lib.build_optimizer(
            a["optimizer"], self.model.named_parameters(), self.base_lr,
            physics_lr_mult=a["physics_lr_mult"], grad_clip=a["grad_clip"],
            bg_lr_mult=a["bg_lr_mult"] if bg_lr_mult is None
            else bg_lr_mult)

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
            self._restore_recipe(recipe_state(restore_dir),
                                 ep_saved=scalars["epoch"])

    def _restore_recipe(self, state, ep_saved):
        """The recipe state of a checkpoint, as the JAX trainer restores
        it. Epochs are rebased by ``ep_saved`` into the resumed run's
        numbering (its loop starts at epoch 1 again)."""
        if state["recons_history"]:
            self._recons_history = [(int(e) - ep_saved, float(r))
                                    for e, r in state["recons_history"]]
            logger.info(
                "auto_rescue stall-guard history restored (%d evals, "
                "rebased to resume epoch 0)", len(self._recons_history))
        if state["rescue_step"] >= 0:
            rc = state["rescue_count"]
            self._rescue_count = rc if rc >= 0 else 1
            self._rescue_step = state["rescue_step"]
            # The optimizer state restored is the one the surgery
            # restarted, and so is its schedule.
            self._opt_step0 = self._rescue_step
            resc_ep = state["rescue_epoch"]
            self._last_rescue_ep = (resc_ep - ep_saved if resc_ep > -(10 ** 8)
                                    else 0)
            logger.info(
                "auto_rescue state restored (surgery at step %d, "
                "%d rescue(s) used); pass --bg_lr_mult=0 to keep the "
                "background frozen on this resume", self._rescue_step,
                self._rescue_count)
        trig = state["aux_trigger_step"]
        if self.aux_on_recons > 0 and trig >= 0:
            self._aux_triggered = True
            self.aux_warmup_steps = trig
            logger.info("aux_on_recons trigger restored from checkpoint "
                        "(fired at step %d)", trig)

    def save(self):
        save_checkpoint(self.save_dir, {
            "model": self.model.state_dict(),
            "optimizer": optimizer_state_by_name(self.model, self.optimizer),
            "step": self.step,
            "epoch": self._cur_epoch,
            "total_epochs_done": self._epoch_base + self._cur_epoch,
            "recipe": {
                "aux_trigger_step": (self.aux_warmup_steps
                                     if self._aux_triggered else -1),
                "rescue_step": self._rescue_step,
                "rescue_count": self._rescue_count,
                "rescue_epoch": self._last_rescue_ep,
                "recons_history": [list(h) for h in
                                   self._recons_history[-64:]]}})

    def add_train_logger(self):
        log_path = os.path.abspath(os.path.join(self.save_dir, "log.txt"))
        for h in logger.handlers:
            if getattr(h, "baseFilename", None) == log_path:
                return
        fh = logging.FileHandler(log_path)
        fh.setFormatter(
            logging.Formatter("%(asctime)s - %(name)s - %(message)s"))
        logger.addHandler(fh)

    # ----- runtime extras -----------------------------------------------------
    def _wd_pet(self):
        """Heartbeat of the watchdog, once per train and eval batch; the
        first one arms it."""
        wd = self._watchdog
        if wd is None:
            if self.watchdog_secs <= 0:
                return
            from paig_reproduction_tpu_torch.train.watchdog import (
                DeviceWatchdog,
            )
            wd = self._watchdog = DeviceWatchdog(
                self.watchdog_secs,
                adaptive_floor_secs=self.watchdog_floor_secs)
            wd.start()
        wd.pet()

    def _start_profiler(self):
        from torch.profiler import (
            ProfilerActivity,
            profile,
            tensorboard_trace_handler,
        )
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities,
                       on_trace_ready=tensorboard_trace_handler(
                           self.profile_dir))
        prof.start()
        return prof

    @contextlib.contextmanager
    def _nan_guard(self):
        """With ``debug_nans``: autograd's anomaly mode with its NaN check
        around a step, its error raised as the FloatingPointError that
        jax_debug_nans raises."""
        if not self.debug_nans:
            yield
            return
        with torch.autograd.set_detect_anomaly(True, check_nan=True):
            try:
                yield
            except RuntimeError as e:
                # Anomaly mode's own error: "Function 'XBackward0' returned
                # nan values in its 0th output."
                if "returned nan values" not in str(e):
                    raise
                raise FloatingPointError(f"{e} (--debug_nans)") from e

    @staticmethod
    def _raise_on_nan(what, tensors: Dict[str, torch.Tensor]):
        """FloatingPointError naming the tensors that hold a NaN (one host
        sync for all of them)."""
        flags = torch.stack([torch.isnan(t).any() for t in tensors.values()])
        if bool(flags.any()):
            bad = [k for k, f in zip(tensors, flags.tolist()) if f]
            raise FloatingPointError(f"NaN in the {what}: {bad} "
                                     f"(--debug_nans)")

    # ----- steps -------------------------------------------------------------
    def _losses(self, batch, net=None, aux_scale=1.0):
        net = self.model if net is None else net
        out, aux = net(batch)
        loss, eval_losses = compute_losses(net, batch, out, aux["recons_out"],
                                           aux, aux_scale=aux_scale)
        if self.debug_nans:
            self._raise_on_nan("forward", {
                "output": out, **{k: aux[k] for k in (
                    "recons_out", "enc_pos", "pos_vel_seq")},
                "train_loss": loss, **eval_losses})
        return loss, eval_losses

    def train_step(self, idx) -> Dict[str, torch.Tensor]:
        """One optimizer step on the train-split sequences ``idx``, with the
        extension losses on from step ``aux_warmup_steps``. Returns the
        step's losses as device tensors."""
        batch = gather_batch(self._split_u8("train"), idx)
        opt_lib.set_lr(self.optimizer,
                       self._lr_at(self.step - self._opt_step0))
        with self._nan_guard():
            loss, eval_losses = self._losses(
                batch, self.train_net,
                aux_scale=1.0 if self.step >= self.aux_warmup_steps else 0.0)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        if self.debug_nans:
            self._raise_on_nan("gradient", {
                n: p.grad for n, p in self.model.named_parameters()
                if p.grad is not None})
        if self.optimizer.grad_clip > 0:
            opt_lib.clip_train_group_(self.optimizer,
                                      self.optimizer.grad_clip)
        self.optimizer.step()
        self.step += 1
        return {**{k: v.detach() for k, v in eval_losses.items()},
                "train_loss": loss.detach()}

    # ----- loops -------------------------------------------------------------
    def train_model(self, epochs, batch_size, save_every_n_epochs,
                    eval_every_n_epochs, print_interval, debug=False):
        """Pre-train valid eval, per-epoch batch loop keyed on the
        iterator's epoch counter, periodic valid evals and saves, a final
        save, then the test eval. With ``profile_dir`` the profiler traces
        everything before the test eval, as the JAX trainer's does."""
        self.batch_size = batch_size
        self.add_train_logger()
        zipdir(root_path, self.save_dir)
        logger.info("\n".join(sys.argv))
        prof = self._start_profiler() if self.profile_dir else None

        if not debug and epochs > 0:
            valid = self.eval_performance(batch_size, type="valid")
            log_metrics(logger, "valid - epoch=%s" % 0, valid)
            self._recons_history.append(
                (0, float(valid["eval_recons_loss"])))

        t0 = time.perf_counter()
        frames = 0
        for ep in range(1, epochs + 1):
            self._cur_epoch = ep
            while self.train_iterator.epochs_completed < ep:
                self._wd_pet()
                step = self.step
                idx = self.train_iterator.next_index_batch(batch_size)
                metrics = self.train_step(idx)
                frames += len(idx) * self.model.seq_len
                if step % print_interval == 0:
                    log_metrics(logger, "train - iter=%s" % step,
                                {"train_loss": float(metrics["train_loss"])})
            if (self.fit_physics_every > 0 and ep >= self.fit_physics_after
                    and (self.aux_on_recons <= 0 or self._aux_triggered)
                    and ep % self.fit_physics_every == 0):
                self._identify_physics(batch_size)
            if ep % eval_every_n_epochs == 0:
                print("eval running")
                valid = self.eval_performance(batch_size, type="valid")
                log_metrics(logger, "valid - epoch=%s" % ep, valid)
                self._after_valid_eval(ep,
                                       float(valid["eval_recons_loss"]))
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
        if prof is not None:
            prof.stop()
            logger.info("profiler trace written to %s", self.profile_dir)

        test_metrics = self.eval_performance(batch_size, type="test",
                                             last=True)
        log_metrics(logger, "test - epoch=%s" % epochs, test_metrics)
        self.flush_artifacts()
        return test_metrics

    def _after_valid_eval(self, ep, recons):
        """The recipe hooks of a valid eval at loop epoch ``ep``: the stall
        history, the --auto_rescue surgery and the --aux_on_recons
        trigger."""
        self._recons_history.append((ep, recons))
        rescued = False
        if (self.auto_rescue > 0 and self._rescue_count < self.max_rescues
                and ep >= self.auto_rescue
                and ep - self._last_rescue_ep >= self.auto_rescue
                and recons > self.rescue_recons
                and self._discovery_stalled(ep, recons)):
            self._do_auto_rescue(ep, recons)
            rescued = True
        # The trigger does not read the recons of the eval that just fired
        # a rescue: the reset model is far above the threshold again.
        if (not rescued and self.aux_on_recons > 0
                and not self._aux_triggered and recons < self.aux_on_recons):
            self._aux_triggered = True
            if self.fit_physics_every > 0:
                # Physics is still uninitialized: the first accepted
                # train-time fit turns the alignment losses on.
                logger.info(
                    "aux_on_recons trigger: valid recons %.3f < %.3f at "
                    "epoch %d (step %d) — train-time physics fits armed; "
                    "alignment losses enable on the first accepted fit",
                    recons, self.aux_on_recons, ep, self.step)
            else:
                self.aux_warmup_steps = self.step
                logger.info(
                    "aux_on_recons trigger: valid recons %.3f < %.3f at "
                    "epoch %d (step %d) — physics-alignment losses now "
                    "active", recons, self.aux_on_recons, ep, self.step)

    def flush_artifacts(self):
        """Block until the outputs.npz writer (if any) has finished."""
        if self._npz_thread is not None:
            self._npz_thread.join()
            self._npz_thread = None

    @torch.no_grad()
    def _eval_losses(self, type, batch_size):
        """Every full batch of one epoch of a split (a split of fewer than
        100 sequences is one batch): ([batches, 3] losses in EVAL_KEYS'
        order, the index batches)."""
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
            self._wd_pet()
            _, eval_losses = self._losses(gather_batch(data_u8, idx))
            per_batch.append(torch.stack([eval_losses[k] for k in EVAL_KEYS]))
        return torch.stack(per_batch).cpu().numpy(), idxs

    def eval_performance(self, batch_size, type="valid", last=False):
        """Whole-epoch metric averages over the split's batches, the
        outputs.npz dump, then the visualization. ``last`` (the run's final
        eval) stops the watchdog once the batches are done: the artifacts
        that follow emit no pets."""
        outputs, idxs = self._eval_losses(type, batch_size)
        if last and self._watchdog is not None:
            self._watchdog.stop()
        self._write_outputs_npz(
            self.get_iterator(type).X[idxs.reshape(-1)], outputs)
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
