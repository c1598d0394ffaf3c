"""The training, evaluation and test loop.

Counterpart of ``paig_reproduction_tpu/train/trainer.py``: the save_dir
wipe or checkpoint restore, the pre-training valid eval, the epoch loop
keyed on the train iterator's epoch counter, ``print_interval`` train
lines, an eval every ``eval_every_n_epochs`` epochs, a checkpoint every
``save_every_n_epochs`` and once more after training, and a test-split eval
at the end, with the same log.txt lines and the same artifacts: code.zip,
model.ckpt, outputs.npz on every eval, and after every valid and test eval
``example%d.jpg``, ``animation%d.gif``, ``templates.jpg`` and
``extra_outputs.npz``, written on writer threads beside the next epoch
(``flush_artifacts`` waits for them). Every split lives on the device as uint8; each step
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

The fused step, the counterpart of the JAX trainer's ``train_chunk`` and
``eval_chunk``: on the card, one train step (the gather and /255 from the
device-resident uint8 split, forward, backward, the gradient reduction of
data parallelism, the clip and the optimizer step) is captured once as a
CUDA graph (``train/graphs.py``) and replayed for each row of a chunk's
``[K, B]`` index matrix, which crosses to the card once per chunk from pinned
memory; before each replay its row, the learning rate and the aux scale are
copied into the graph's static device tensors, and each step's losses into
a ``[K, 4]`` device buffer that is fetched only when log lines need it (the
deferred drain: ``log.txt`` gets the eager loop's ``train - iter=`` lines in
the same order). An eval epoch replays a captured eval batch (one graph per
split and batch shape) over its index batches and fetches its ``[K, 3]``
losses once. A chunk holds at most ``_chunk_len`` steps (``PAIG_CHUNK_STEPS``
overrides) and stops at the epoch's end. A graph is captured again when
what it reads or writes gets new storage (a new optimizer, a restore);
in-place writes (the surgery, the physics fit, a discovery arm's fresh
weights) need none. ``fused_off_reason`` is the one predicate of the fused
path, shared by ``train_model``, the discovery arms and the evals; with
``PAIG_FUSED=1`` on the CPU the same chunk code calls the step body
directly. A capture on a configuration the predicate admits raises on
failure: there is no eager fallback.

``--native_loader`` (``data/native.py``) takes the JAX trainer's host path
where the fused path is off, as the JAX trainer builds its loader only
then: the C++ loader's batches, each fed to the captured step through a
static batch buffer. Where the fused path is on, the flag changes nothing:
the chunks gather their batches on the device.

Data and tensor parallelism come from the ``mesh`` (``parallel/mesh.py``):
each data rank computes its rows of every global batch, the split kernels
compute through their model group, and only the first process writes the
run's files (``log.txt``, code.zip, the checkpoint with every split tensor
gathered whole, outputs.npz and the visualizations).
"""
from __future__ import annotations

import contextlib
import logging
import os
import shutil
import sys
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from paig_reproduction_tpu_torch.data.iterators import gather_batch, to_device
from paig_reproduction_tpu_torch.models.physics_net import (
    PhysicsNet,
    compute_losses,
)
from paig_reproduction_tpu_torch.parallel import mesh as mesh_lib
from paig_reproduction_tpu_torch.parallel.distributed import local_device
from paig_reproduction_tpu_torch.train import optimizers as opt_lib
from paig_reproduction_tpu_torch.train.graphs import CapturedStep
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
# The graph capture of the fused step by device type; where there is none
# (the CPU), the step body is called directly.
CAPTURE_CLASSES = {"cuda": CapturedStep}
# A train step's losses, in the order of its [4] loss vector.
STEP_KEYS = EVAL_KEYS + ("train_loss",)


class Trainer(RecipeMixin):
    """Owns the model on its device, the optimizer, the device-resident
    data splits, the recipe state and the run's artifacts. ``seed`` seeds
    the discovery arms' weights and the native loader's shuffle;
    ``enhancers_eval_only`` trains without the inference enhancers;
    ``mesh`` (``parallel/mesh.py``) lays the model and the batches out over
    the processes, whose TP kernels are split here."""

    def __init__(self, model: PhysicsNet, device="cuda", seed: int = 0,
                 enhancers_eval_only: bool = False, profile_dir: str = "",
                 native_loader: bool = False,
                 mesh: Optional[mesh_lib.Mesh] = None):
        self.device = local_device(device)
        if self.device.type == "cuda":
            use_full_f32()
        self.mesh = mesh if mesh is not None else mesh_lib.Mesh()
        # {parameter name: split dim} of the TP kernels.
        self._split = (mesh_lib.shard_model(model, self.mesh)
                       if self.mesh.shape["model"] > 1 else {})
        self.model = model.to(self.device)
        self._writer = self.mesh.rank == 0
        self.native_loader = native_loader
        # The step's learning rate and aux scale, on the device: every
        # optimizer group reads its rate from the first (a view).
        self._scalars = torch.zeros(2, device=self.device)
        # The fused path: static tensors and graphs by key, the signature
        # each key was warmed up at, and the capture (None on the CPU,
        # where the step body is called directly).
        self._static: Dict[tuple, torch.Tensor] = {}
        self._graphs: Dict[tuple, CapturedStep] = {}
        self._warm: Dict[tuple, tuple] = {}
        self._capture_cls = CAPTURE_CLASSES.get(self.device.type)
        self._fused_logged = False
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
        # Artifact writer threads by name: (thread, [its exception]).
        self._writer_threads = {}
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
        # Epochs the discovery arms used before train_model's loop (0 on a
        # resume, as in the JAX trainer); the restored chain's arm epochs,
        # and its arm and loop epochs (--resume_remaining_epochs).
        self._epochs_consumed = 0
        self._arm_epochs = 0
        self._chain_epochs = 0
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
        opt = opt_lib.build_optimizer(
            a["optimizer"], self.model.named_parameters(), self.base_lr,
            physics_lr_mult=a["physics_lr_mult"], grad_clip=a["grad_clip"],
            bg_lr_mult=a["bg_lr_mult"] if bg_lr_mult is None
            else bg_lr_mult)
        opt_lib.set_lr(opt, self._scalars[0])
        return opt

    # ----- checkpoint / save_dir semantics ----------------------------------
    def initialize_graph(self, save_dir, use_ckpt=False, ckpt_dir=""):
        """The JAX package's save_dir semantics: a fresh run WIPES an
        existing save_dir; ``use_ckpt`` restores from ``ckpt_dir``, or from
        ``save_dir`` when ``ckpt_dir`` is empty and save_dir exists. The
        restored step sets the LR schedule's position."""
        self.save_dir = save_dir
        restore, restore_dir = False, save_dir
        existed = os.path.exists(save_dir)
        self._barrier()
        if existed:
            if use_ckpt:
                restore = True
                restore_dir = ckpt_dir if ckpt_dir else save_dir
            elif self._writer:
                logger.info("Folder exists, deleting...")
                shutil.rmtree(save_dir)
                os.makedirs(save_dir)
        else:
            if self._writer:
                os.makedirs(save_dir)
            if use_ckpt:
                restore = True
                restore_dir = ckpt_dir
        self._barrier()

        if restore:
            print(f"Loading model from: {restore_dir}/model.ckpt")
            # Under tensor parallelism each saved tensor is cut to this
            # process's slice.
            split = {"piece": self._piece} if self._split else {}
            scalars = restore_checkpoint(restore_dir, self.model,
                                         self.optimizer, **split)
            self.step = scalars["step"]
            self._epoch_base = max(scalars["total_epochs_done"],
                                   scalars["epoch"])
            self._restore_recipe(recipe_state(restore_dir),
                                 ep_saved=scalars["epoch"])

    def _restore_recipe(self, state, ep_saved):
        """The recipe state of a checkpoint, as the JAX trainer restores
        it. Epochs are rebased by ``ep_saved`` into the resumed run's
        numbering (its loop starts at epoch 1 again)."""
        # --epochs that the chain has used: its arms' and its loop epochs.
        self._arm_epochs = int(state["arm_epochs"])
        self._chain_epochs = self._arm_epochs + self._epoch_base
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

    # ----- processes ---------------------------------------------------------
    def _barrier(self):
        if self.mesh.distributed:
            dist.barrier()

    def _piece(self, name, full):
        """This process's slice of a whole tensor of parameter ``name``."""
        dim = self._split.get(name)
        return full if dim is None else mesh_lib.piece(full, dim, self.mesh)

    def _whole(self, name, local):
        """A tensor of parameter ``name`` made whole from every model
        rank's slice (a collective: every process calls it)."""
        dim = self._split.get(name)
        return local if dim is None else mesh_lib.gather(local, dim,
                                                         self.mesh)

    def load_whole_state(self, state):
        """Load a whole model's state_dict into this process's slices."""
        self.model.load_state_dict({k: self._piece(k, v)
                                    for k, v in state.items()})

    def save(self):
        """model.ckpt, written by the first process with every split tensor
        gathered whole (every process takes part)."""
        model = {k: self._whole(k, v)
                 for k, v in self.model.state_dict().items()}
        optimizer = optimizer_state_by_name(self.model, self.optimizer)
        optimizer["state"] = {
            n: {k: self._whole(n, v) if v.dim() else v for k, v in st.items()}
            for n, st in optimizer["state"].items()}
        if not self._writer:
            return
        save_checkpoint(self.save_dir, {
            "model": model,
            "optimizer": optimizer,
            "step": self.step,
            "epoch": self._cur_epoch,
            "total_epochs_done": self._epoch_base + self._cur_epoch,
            "recipe": {
                "aux_trigger_step": (self.aux_warmup_steps
                                     if self._aux_triggered else -1),
                "rescue_step": self._rescue_step,
                "rescue_count": self._rescue_count,
                "rescue_epoch": self._last_rescue_ep,
                "arm_epochs": self._arm_epochs,
                "recons_history": [list(h) for h in
                                   self._recons_history[-64:]]}})

    def add_train_logger(self):
        if not self._writer:
            return
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

    def _fill_scalars(self, step):
        """The learning rate and aux scale of step ``step`` into the
        device scalars."""
        self._scalars[0].fill_(self._lr_at(step - self._opt_step0))
        self._scalars[1].fill_(1.0 if step >= self.aux_warmup_steps else 0.0)

    def _forward_backward(self, batch) -> torch.Tensor:
        """Forward and backward of the train model on this process's rows
        ``batch`` at the aux scale in the device scalars, the gradients
        reduced over the mesh. Returns the [4] losses (``STEP_KEYS``),
        averaged over the data ranks."""
        loss, eval_losses = self._losses(batch, self.train_net,
                                         aux_scale=self._scalars[1])
        self.optimizer.zero_grad(set_to_none=True)
        seed = self.mesh.loss_seed
        (loss * seed if seed != 1.0 else loss).backward()
        losses = torch.stack([eval_losses[k] for k in EVAL_KEYS]
                             + [loss]).detach()
        if self.mesh.distributed:
            params = [p for g in self.optimizer.param_groups
                      for p in g["params"]]
            split = {id(p) for n, p in self.model.named_parameters()
                     if n in self._split}
            mesh_lib.average_gradients(
                [p for p in params if id(p) not in split],
                [p for p in params if id(p) in split], self.mesh)
            losses = mesh_lib.mean_over_data(losses, self.mesh)
        return losses

    def _step(self, batch) -> torch.Tensor:
        """One optimizer step on ``batch`` at the learning rate and aux
        scale in the device scalars: the body that the fused path captures
        and the eager step calls. Returns the [4] losses."""
        opt_lib.set_lr(self.optimizer, self._scalars[0])
        losses = self._forward_backward(batch)
        if self.debug_nans:
            self._raise_on_nan("gradient", {
                n: p.grad for n, p in self.model.named_parameters()
                if p.grad is not None})
        if self.optimizer.grad_clip > 0:
            opt_lib.clip_train_group_(
                self.optimizer, self.optimizer.grad_clip,
                **self._clip_split())
        self.optimizer.step()
        return losses

    def _clip_split(self) -> dict:
        """The split kernels and their group, for the global norm of the
        clip under tensor parallelism."""
        if not self._split:
            return {}
        return {"split": [p for n, p in self.model.named_parameters()
                          if n in self._split],
                "group": self.mesh.model_group}

    def train_step(self, idx) -> Dict[str, torch.Tensor]:
        """One eager optimizer step on the train-split sequences ``idx``
        (this process computes its rows of them), with the extension losses
        on from step ``aux_warmup_steps``. Returns the step's losses as
        device tensors."""
        idx = np.asarray(idx)
        batch = gather_batch(self._split_u8("train"),
                             idx[self.mesh.rows(len(idx))])
        self._fill_scalars(self.step)
        with self._nan_guard():
            losses = self._step(batch)
        self.step += 1
        return dict(zip(STEP_KEYS, losses))

    # ----- the fused path ---------------------------------------------------
    def fused_off_reason(self, batch_size, type="train") -> Optional[str]:
        """Why the fused path (``train_chunk``, and the captured eval epoch
        for ``type`` other than train) does not run here, or None where it
        does. The one predicate of the fused path, for train_model, the
        discovery arms and the evals. Its named exclusions:

        * ``PAIG_FUSED=0``; and the CPU unless ``PAIG_FUSED=1`` (where the
          chunk calls the step body directly, uncaptured);
        * ``--debug_nans``: anomaly mode and the NaN checks read values on
          the host at every operation, which a capture forbids;
        * a ``gloo`` process group on the card: gloo's collectives run on
          the host and cannot be captured;
        * a split without its uint8 frames, or with fewer sequences than a
          batch;
        * a batch that the data ranks do not divide (train).
        """
        env = os.environ.get("PAIG_FUSED")
        if env == "0":
            return "PAIG_FUSED=0"
        if self.device.type == "cpu" and env != "1":
            return "the CPU; PAIG_FUSED=1 runs the chunk there, uncaptured"
        reason = self._capture_off_reason()
        if reason:
            return reason
        it = self.get_iterator(type)
        if getattr(it, "raw_uint8", None) is None:
            return f"the {type} split has no uint8 frames"
        if it.num_examples < batch_size:
            return f"the {type} split is smaller than a batch"
        if type == "train" and batch_size % self.mesh.shape["data"]:
            return (f"B={batch_size} does not divide over "
                    f"{self.mesh.shape['data']} data ranks")
        return None

    def _capture_off_reason(self) -> Optional[str]:
        """Why no step may be captured here, or None: the predicate's
        exclusions that also hold for the native loader's step."""
        if self.debug_nans:
            return "--debug_nans syncs the host at every operation"
        if (self.mesh.distributed and self.device.type == "cuda"
                and dist.get_backend() != "nccl"):
            return f"{dist.get_backend()} collectives cannot be captured"
        return None

    def _fused_train(self, batch_size) -> bool:
        """Whether the train loop runs fused chunks; logged once."""
        reason = self.fused_off_reason(batch_size)
        if not self._fused_logged:
            self._fused_logged = True
            logger.info("fused step: %s", "off (%s)" % reason if reason else
                        "on (%s)" % ("captured CUDA graph"
                                     if self._capture_cls else
                                     "the step body called directly"))
        return reason is None

    def _chunk_len(self, print_interval=0):
        """Steps a fused chunk holds at most: 128 on the card, 25 on the
        CPU, at least ``print_interval``; ``PAIG_CHUNK_STEPS`` overrides.
        ``next_index_batches`` ends a chunk at the epoch's end."""
        chunk_env = int(os.environ.get("PAIG_CHUNK_STEPS", "0"))
        if chunk_env > 0:
            return chunk_env
        base = 25 if self.device.type == "cpu" else 128
        return max(base, print_interval)

    def _buffer(self, key, shape, dtype=torch.float32):
        """A static device tensor of the fused path, made once."""
        if key not in self._static:
            self._static[key] = torch.zeros(shape, dtype=dtype,
                                            device=self.device)
        return self._static[key]

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        """A host array on the device, through pinned memory on the
        card."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _signature(self, key) -> tuple:
        """The storages a graph of ``key`` reads and writes: the
        parameters, the data split and, for a train step, the optimizer
        and its state."""
        ptrs = [p.data_ptr() for p in self.model.parameters()]
        if key[0] == "eval":
            ptrs.append(self._split_u8(key[1]).data_ptr())
        else:
            if key[0] == "train":
                ptrs.append(self._split_u8("train").data_ptr())
            ptrs.append(id(self.optimizer))
            ptrs += [t.data_ptr() for st in self.optimizer.state.values()
                     for t in st.values()]
        return tuple(ptrs)

    def _run(self, key, body):
        """Run ``body`` once. On the CPU, and where ``_capture_off_reason``
        forbids a capture, it is called directly. On the card the first
        call under a signature is a real step on a side stream (the
        warm-up), the next one captures the graph, and every call replays
        it; a changed signature captures again."""
        if self._capture_cls is None or self._capture_off_reason():
            with self._nan_guard():
                body()
            return
        g = self._graphs.get(key)
        if g is not None and g.signature != self._signature(key):
            del self._graphs[key]
            g = None
        if g is None:
            sig = self._signature(key)
            if self._warm.get(key) != sig:
                self._capture_cls.warm_up(body, self.device)
                self._warm[key] = self._signature(key)
                return
            g = self._graphs[key] = self._capture_cls(body, sig)
        g.replay()

    def release_graphs(self):
        """Drop every captured graph and its memory."""
        self._graphs.clear()
        self._warm.clear()

    def graph_stats(self) -> dict:
        """{key: (replays, decoder launches a replay)} of the graphs."""
        return {k: (g.replays, g.launches) for k, g in self._graphs.items()}

    def train_chunk(self, batch_size, chunk_k):
        """One fused chunk: up to ``chunk_k`` index batches from the train
        iterator (ending at the epoch's end), each one optimizer step
        through the captured step. Returns (steps done, their [K, 4] device
        losses)."""
        idxs = self.train_iterator.next_index_batches(batch_size, chunk_k)
        idxs = idxs[:, self.mesh.rows(batch_size)]
        k, b = idxs.shape
        steps = np.arange(self.step, self.step + k)
        scalars = np.stack(
            [[self._lr_at(s - self._opt_step0) for s in steps],
             steps >= self.aux_warmup_steps], axis=1).astype(np.float32)
        idx_d = self._upload(idxs.astype(np.int64))
        scalars_d = self._upload(scalars)
        key = ("train", b)
        static_idx = self._buffer(key + ("idx",), (b,), torch.int64)
        static_out = self._buffer(key + ("out",), (4,))
        data_u8 = self._split_u8("train")

        def body():
            static_out.copy_(self._step(gather_batch(data_u8, static_idx)))

        out = torch.empty((k, 4), device=self.device)
        for i in range(k):
            static_idx.copy_(idx_d[i])
            self._scalars.copy_(scalars_d[i])
            self._run(key, body)
            out[i].copy_(static_out)
        self.step += k
        return k, out

    def _native_step(self, native, batch_size) -> torch.Tensor:
        """One optimizer step on the native loader's next batch, fed to the
        captured step through a static batch buffer. Returns its [1, 4]
        device losses."""
        rows = self.mesh.rows(batch_size)
        b = rows.stop - rows.start
        m = self.model
        key = ("native", b)
        static_batch = self._buffer(
            key + ("batch",), (b, m.seq_len, m.conv_ch, m.img_size,
                               m.img_size))
        static_out = self._buffer(key + ("out",), (4,))
        native.next_batch_into(static_batch, rows)
        self._fill_scalars(self.step)

        def body():
            static_out.copy_(self._step(static_batch))

        self._run(key, body)
        self.step += 1
        return static_out.clone()[None]

    def _make_native(self, batch_size):
        """The C++ loader over the train split (``data/native.py``); raises
        where it cannot be built or the split is smaller than a batch."""
        from paig_reproduction_tpu_torch.data.native import NativeBatcher
        raw = getattr(self.train_iterator, "raw_uint8", None)
        if raw is None:
            raise ValueError("--native_loader needs the train split's uint8 "
                             "frames")
        native = NativeBatcher(raw, batch_size, seed=self.seed,
                               pin=self.device.type == "cuda")
        logger.info("using native C++ prefetching loader")
        return native

    # ----- loops -------------------------------------------------------------
    def train_model(self, epochs, batch_size, save_every_n_epochs,
                    eval_every_n_epochs, print_interval, debug=False):
        """Pre-train valid eval, per-epoch batch loop keyed on the
        iterator's epoch counter, periodic valid evals and saves, a final
        save, then the test eval. With ``profile_dir`` the profiler traces
        everything before the test eval, as the JAX trainer's does."""
        self.batch_size = batch_size
        self.add_train_logger()
        if self._writer:
            zipdir(root_path, self.save_dir)
        logger.info("\n".join(sys.argv))
        prof = self._start_profiler() if self.profile_dir else None

        if not debug and epochs > 0:
            valid = self.eval_performance(batch_size, type="valid")
            log_metrics(logger, "valid - epoch=%s" % 0, valid)
            self._recons_history.append(
                (0, float(valid["eval_recons_loss"])))

        fused = epochs > 0 and self._fused_train(batch_size)
        # The C++ loader feeds the step only where the chunks do not, as in
        # the JAX trainer.
        native = (self._make_native(batch_size)
                  if epochs > 0 and self.native_loader and not fused
                  else None)
        chunk_k = self._chunk_len(print_interval)
        # The deferred drain: each chunk's [K, 4] losses stay on the device,
        # (device losses, first step, steps); they are fetched, in one copy,
        # at epochs that log, evaluate or save, when more than 8 are pending
        # (all but the newest, which may still run) and at the loop's end.
        pending = []

        def drain(keep_last=False):
            nonlocal pending
            tail = [pending.pop()] if keep_last and pending else []
            todo = [e for e in pending
                    if any((e[1] + i) % print_interval == 0
                           for i in range(e[2]))]
            if todo:
                host = torch.cat([m for m, _, _ in todo]).cpu().numpy()
                row = 0
                for _, step0, n in todo:
                    for i in range(n):
                        if (step0 + i) % print_interval == 0:
                            log_metrics(
                                logger, "train - iter=%s" % (step0 + i),
                                {"train_loss": float(host[row + i, 3])})
                    row += n
            pending = tail

        t0 = time.perf_counter()
        frames = 0
        for ep in range(1, epochs + 1):
            self._cur_epoch = ep
            while (native.epochs_completed if native is not None
                   else self.train_iterator.epochs_completed) < ep:
                self._wd_pet()
                step = self.step
                if native is not None or fused:
                    if native is not None:
                        n, out = 1, self._native_step(native, batch_size)
                    else:
                        n, out = self.train_chunk(batch_size, chunk_k)
                    frames += n * batch_size * self.model.seq_len
                    pending.append((out, step, n))
                    if len(pending) > 8:
                        drain(keep_last=True)
                    continue
                idx = self.train_iterator.next_index_batch(batch_size)
                metrics = self.train_step(idx)
                frames += len(idx) * self.model.seq_len
                if step % print_interval == 0:
                    log_metrics(logger, "train - iter=%s" % step,
                                {"train_loss": float(metrics["train_loss"])})
            if (ep % eval_every_n_epochs == 0 or ep % save_every_n_epochs == 0
                    or (self.fit_physics_every > 0
                        and ep % self.fit_physics_every == 0)):
                drain()
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

        drain()
        if native is not None:
            native.close()
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
        self.release_graphs()
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
        """Block until the artifact writers (outputs.npz, the
        visualization's files) have finished; re-raise what one raised."""
        for name in list(self._writer_threads):
            self._join_writer(name)

    def _join_writer(self, name):
        thread, failed = self._writer_threads.pop(name, (None, None))
        if thread is None:
            return
        thread.join()
        if failed:
            raise failed[0]

    def _in_background(self, name, fn, *args, **kwargs):
        """Run ``fn`` on a writer thread of its own, after the earlier
        writer of ``name`` (the same files) has finished. The thread is
        not a daemon: the process waits for it at exit."""
        self._join_writer(name)
        failed = []

        def run():
            try:
                fn(*args, **kwargs)
            except BaseException as e:          # re-raised by the join
                failed.append(e)

        thread = threading.Thread(target=run, daemon=False)
        self._writer_threads[name] = (thread, failed)
        thread.start()

    @torch.no_grad()
    def _eval_losses(self, type, batch_size):
        """Every full batch of one epoch of a split (a split of fewer than
        100 sequences is one batch): ([batches, 3] losses in EVAL_KEYS'
        order, the index batches). Fused, a captured eval batch is replayed
        over the epoch's index batches and the losses fetched once. Each
        data rank computes its rows of every batch."""
        eval_iterator = self.get_iterator(type)
        eval_iterator.reset_epoch()
        n = eval_iterator.X.shape[0]
        if n < 100:
            batch_size = n
        # Every index batch of one epoch (the ragged tail is dropped).
        idxs = eval_iterator.next_index_batches(batch_size, 10 ** 9)
        rows = self.mesh.rows(batch_size)
        local = idxs[:, rows]
        data_u8 = self._split_u8(type)
        if self.fused_off_reason(batch_size, type) is None:
            self._wd_pet()
            key = ("eval", type, local.shape[1])
            static_idx = self._buffer(key + ("idx",), (local.shape[1],),
                                      torch.int64)
            static_out = self._buffer(key + ("out",), (len(EVAL_KEYS),))

            def body():
                _, eval_losses = self._losses(gather_batch(data_u8,
                                                           static_idx))
                static_out.copy_(torch.stack([eval_losses[k]
                                              for k in EVAL_KEYS]))

            idx_d = self._upload(local.astype(np.int64))
            losses = torch.empty((len(local), len(EVAL_KEYS)),
                                 device=self.device)
            for i in range(len(local)):
                static_idx.copy_(idx_d[i])
                self._run(key, body)
                losses[i].copy_(static_out)
        else:
            per_batch = []
            for idx in local:
                self._wd_pet()
                _, eval_losses = self._losses(gather_batch(data_u8, idx))
                per_batch.append(torch.stack([eval_losses[k]
                                              for k in EVAL_KEYS]))
            losses = torch.stack(per_batch)
        if self.mesh.distributed:
            losses = mesh_lib.mean_over_data(losses, self.mesh)
        return losses.cpu().numpy(), idxs

    def eval_performance(self, batch_size, type="valid", last=False):
        """Whole-epoch metric averages over the split's batches, the
        outputs.npz dump, then the visualization. ``last`` (the run's final
        eval) stops the watchdog once the batches are done: the artifacts
        that follow emit no pets."""
        outputs, idxs = self._eval_losses(type, batch_size)
        if last and self._watchdog is not None:
            self._watchdog.stop()
        if self._writer:
            self._write_outputs_npz(
                self.get_iterator(type).X[idxs.reshape(-1)], outputs)
        self.visualize_sequence()
        means = outputs.mean(axis=0)
        return {k: means[i] for i, k in enumerate(EVAL_KEYS)}

    def _write_outputs_npz(self, inputs, outputs):
        """outputs.npz (``input``: the split's evaluated sequences;
        ``output``: each batch's pred, extrap and recons losses), written
        by a writer thread after any earlier one has finished."""
        self._in_background("npz", savez_fast,
                            os.path.join(self.save_dir, "outputs.npz"),
                            input=inputs, output=outputs)

    # ----- visualization ------------------------------------------------------
    @torch.no_grad()
    def visualize_sequence(self):
        """The JAX package's visualization artifacts, from the model run on
        the next test batch of min(batch_size, $PAIG_VIZ_EXAMPLES=8)
        sequences: example%d.jpg (rows: prediction / ground truth /
        reconstruction), animation%d.gif (output over ground-truth strips),
        extra_outputs.npz and templates.jpg (sigmoid(contents) above
        sigmoid(template - 5)), written by ``write_visualization`` on a
        writer thread."""
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
        if not self._writer:
            return

        output_seq = np.concatenate(
            [batch_x[:, :model.input_steps], output_seq], axis=1)
        recons_seq = np.concatenate(
            [recons_seq,
             np.zeros((batch_size, model.extrap_steps)
                      + recons_seq.shape[2:])], axis=1)

        self._in_background(
            "viz", write_visualization, self.save_dir, batch_x, output_seq,
            recons_seq, extras, seq_len=model.seq_len,
            img_size=model.img_size, conv_ch=model.conv_ch,
            n_objs=model.n_objs)


def write_visualization(save_dir, batch_x, output_seq, recons_seq, extras,
                        seq_len, img_size, conv_ch, n_objs):
    """The visualization's files from its host arrays (``visualize_sequence``
    runs this on a writer thread): example%d.jpg, animation%d.gif,
    extra_outputs.npz and templates.jpg. The example JPEGs are encoded on
    a few threads while this one writes the rest (numpy releases the
    interpreter lock in their transforms)."""
    from concurrent.futures import ThreadPoolExecutor
    batch_size = batch_x.shape[0]
    h = w = img_size

    def example(i):
        total_seq = np.concatenate(
            [output_seq[i], batch_x[i], recons_seq[i]], axis=0)
        total_seq = np.transpose(total_seq, (0, 2, 3, 1))
        save_image(os.path.join(save_dir, "example%d.jpg" % i),
                   gallery(total_seq, ncols=batch_x.shape[1]))

    with ThreadPoolExecutor(max_workers=min(4, batch_size)) as pool:
        examples = [pool.submit(example, i) for i in range(batch_size)]
        out_nhwc = np.transpose(output_seq, (0, 1, 3, 4, 2))
        gt_nhwc = np.transpose(batch_x, (0, 1, 3, 4, 2))
        if conv_ch == 1:
            out_nhwc = np.repeat(out_nhwc, 3, axis=-1)
            gt_nhwc = np.repeat(gt_nhwc, 3, axis=-1)
        bordered_out = 0.5 * np.ones([batch_size, seq_len, h + 2, w + 2, 3])
        bordered_gt = 0.5 * np.ones_like(bordered_out)
        bordered_out[:, :, 1:-1, 1:-1] = out_nhwc
        bordered_gt[:, :, 1:-1, 1:-1] = gt_nhwc
        strip_out = np.concatenate(list(bordered_out), axis=-2)
        strip_gt = np.concatenate(list(bordered_gt), axis=-2)
        frames = np.concatenate([strip_out, strip_gt], axis=1)
        gif(os.path.join(save_dir, "animation%d.gif" % (batch_size - 1)),
            frames * 255, fps=7, scale=3)

        np.savez_compressed(os.path.join(save_dir, "extra_outputs.npz"),
                            **extras)

        contents = np.transpose(extras["contents"], (0, 2, 3, 1))
        templates = np.transpose(extras["templates"], (0, 2, 3, 1))
        contents = 1 / (1 + np.exp(-contents))
        templates = 1 / (1 + np.exp(-(templates - 5)))
        if conv_ch == 1:
            contents = np.tile(contents, [1, 1, 1, 3])
        templates = np.tile(templates, [1, 1, 1, 3])
        save_image(os.path.join(save_dir, "templates.jpg"),
                   gallery(np.concatenate([contents, templates], axis=0),
                           ncols=n_objs))
        for f in examples:
            f.result()
