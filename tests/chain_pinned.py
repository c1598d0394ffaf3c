"""3bp_color's pinned stage in both packages from one state, shared by
``tests/test_torch_chain_pinned.py`` and ``tests/chain_pinned_study.py``.

The state is the tracked ``curriculum_3`` checkpoint
(``reference_runs.CURRICULUM_3``) after the chain's all-slot surgery
(``reference_runs.SURGERY_FLAGS``, the port's ``slot_rescue``). Both
packages train it as the chain's ``pinned`` stage does: its flags
(``--bg_lr_mult=0``, the 1000-epoch schedule), a fresh RMSprop, the aux
losses on from step 0, 20 steps an epoch (the tracked 2000-sequence train
file at B=100). The port runs its Trainer on the CPU; the JAX package its
model, ``build_optimizer`` and ``compute_losses`` in one jitted step, on
the surgery's output carried over by ``chain_state_study.port_to_flax``.
"""
import os

import jax
import optax

import jax_3bp
from chain_state_study import port_to_flax
from paig_reproduction_tpu.models.physics_net import compute_losses
from paig_reproduction_tpu.train import optimizers as jax_opt
from paig_reproduction_tpu_torch import cli
from paig_reproduction_tpu_torch.data import iterators
from paig_reproduction_tpu_torch.tools import reference_runs as rr
from paig_reproduction_tpu_torch.tools import slot_rescue
from paig_reproduction_tpu_torch.train import checkpoint
from paig_reproduction_tpu_torch.train.trainer import Trainer

SL20 = os.path.join(rr.TRACKED_DATA, cli.TASK_TABLE["3bp_color"][0])
STEPS_PER_EPOCH = 20


def pinned_argv() -> list:
    """The flags of 3bp_chain's pinned stage (its CLI argv less the
    directories, the data and the device)."""
    return next(s["argv"] for s in rr.CHAINS["3bp_chain"]["stages"]()
                if s["name"] == "pinned")


def surgery(out_dir, ckpt_dir=None, data_dir=rr.TRACKED_DATA):
    """The port's slot_rescue with the chain's SURGERY_FLAGS on the
    checkpoint in ``ckpt_dir`` (by default CURRICULUM_3; the train file's
    median background from ``data_dir``), written to ``out_dir``; returns
    ``out_dir``."""
    if not os.path.exists(os.path.join(out_dir, checkpoint.CKPT_NAME)):
        slot_rescue.main([f"--ckpt_dir={ckpt_dir or rr.CURRICULUM_3}",
                          f"--out_dir={out_dir}",
                          "--task=3bp_color", f"--data_dir={data_dir}",
                          *rr.SURGERY_FLAGS])
    return out_dir


def port_trainer(ckpt_dir, run_dir, data_path=SL20):
    """The port's Trainer of the pinned stage's flags on the CPU, on the
    split at ``data_path``, restored from ``ckpt_dir`` (the optimizer
    fresh, as the pinned stage restores the surgery's checkpoint)."""
    args = cli.build_parser().parse_args(pinned_argv() + ["--device=cpu"])
    trainer = Trainer(cli.build_model(args, 20), device="cpu",
                      seed=args.seed)
    trainer.get_data(iterators.get_iterators(str(data_path), conv=True))
    trainer.build_optimizer(args.base_lr, args.optimizer, args.anneal_lr,
                            epochs=args.epochs,
                            steps_per_epoch=STEPS_PER_EPOCH,
                            aux_warmup_epochs=args.aux_warmup_epochs,
                            bg_lr_mult=args.bg_lr_mult)
    trainer.initialize_graph(str(run_dir), use_ckpt=True,
                             ckpt_dir=str(ckpt_dir))
    return trainer


def jax_model():
    """The JAX package's PhysicsNet of the pinned stage's flags."""
    return jax_3bp.jax_model(pinned_argv() + ["--device=cpu"])[0]


def jax_params(ckpt_dir, model):
    """The port checkpoint in ``ckpt_dir`` as the JAX model's params;
    asserts that it holds every leaf of the model's, at its shape."""
    params = port_to_flax(checkpoint.load_checkpoint(ckpt_dir)["model"])
    x = jax.ShapeDtypeStruct((1, model.seq_len, 3, 36, 36), "float32")
    init = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)["params"]
    assert (jax.tree.structure(params) == jax.tree.structure(init)), \
        "the checkpoint does not fill the JAX model's params"
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(init)):
        assert a.shape == b.shape and a.dtype == b.dtype
    return params


def train_losses(model, x, out, aux, aux_scale=1.0):
    """The JAX trainer's train loss and eval losses (its
    ``make_loss_fn``)."""
    return compute_losses(
        model, x, out, aux["recons_out"], aux.get("center_penalty"),
        aux.get("vel_anchor_penalty"), aux.get("coarse_pred_loss"),
        aux.get("pos_consistency_loss"), aux.get("attn_overlap_penalty"),
        aux_scale=aux_scale)


def jax_step_fn(model, params, lr_dtype=None):
    """(optax transform, jitted step) of the JAX package's pinned stage:
    RMSprop over its 1000-epoch schedule with the background frozen
    (``bg_lr_mult=0``), the aux losses on; the schedule's rate cast to
    ``lr_dtype`` where one is given (float32 for a float64 run, as the
    port's rate is). The step returns (params, optimizer state, train
    loss, eval losses)."""
    args = cli.build_parser().parse_args(pinned_argv())
    assert args.bg_lr_mult == 0.0 and args.aux_warmup_epochs == 0
    schedule = jax_opt.lr_schedule(args.base_lr, args.epochs,
                                   STEPS_PER_EPOCH, args.anneal_lr)
    if lr_dtype is not None:
        rate = schedule

        def schedule(count):
            return rate(count).astype(lr_dtype)
    tx = jax_opt.build_optimizer(args.optimizer, schedule, params,
                                 bg_lr_mult=args.bg_lr_mult)

    @jax.jit
    def step(p, opt_state, batch):
        def loss_fn(q):
            out, aux = model.apply({"params": q}, batch)
            return train_losses(model, batch, out, aux)
        (loss, ev), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss, ev

    return tx, step


def nudged_steps(start, data_path, port_nudges, jax_nudges, steps,
                 batch=8, seed=0):
    """Both packages' pinned steps from the surgery's output in ``start``
    on the train split at ``data_path``: one port trainer for each of
    ``port_nudges`` and one JAX run for each of ``jax_nudges`` (the start's
    parameters times 1 + nudge), every run on the same ``batch``-sequence
    index batches (``RandomState(seed)``). Yields, after each step, (the
    port runs' parameters, the JAX runs' parameters), each a list of
    numpy dicts by the port's names, and the split's frames last."""
    import numpy as np
    import torch
    from paig_reproduction_tpu_torch.convert import flax_to_state_dict
    from spring_pair import nudged

    ports = []
    for by in port_nudges:
        trainer = port_trainer(start, os.path.join(
            os.path.dirname(str(data_path)), "port_run"), data_path)
        assert trainer.step == trainer.opt_count == 0
        with torch.no_grad():
            for p in trainer.model.parameters():
                p.mul_(1 + by)
        ports.append(trainer)
    x = ports[0].train_iterator.raw_uint8.astype(np.float32) / 255
    model = jax_model()
    params = jax_params(start, model)
    tx, step = jax_step_fn(model, params)
    runs = [[p, tx.init(p)] for p in (nudged(params, by)
                                      for by in jax_nudges)]
    rs = np.random.RandomState(seed)
    for _ in range(steps):
        idx = rs.choice(len(x), batch, replace=False)
        for run in runs:
            run[0], run[1], _, _ = step(run[0], run[1], x[idx])
        for trainer in ports:
            trainer.train_step(idx)
        jax_states = [{k: v.numpy() for k, v in flax_to_state_dict(
            jax.device_get(run[0])).items()} for run in runs]
        yield ([{k: v.detach().numpy().copy() for k, v in
                 t.model.state_dict().items() if k in jax_states[0]}
                for t in ports], jax_states, x)


def loss64(net, states, x):
    """The port's train loss of each parameter dict in ``states`` in
    float64 on the frames ``x``, through ``net`` (a port model, made
    float64 here): one evaluator for both packages' states. The jitted JAX
    step's own float32 loss carries XLA CPU's three-axis-sum error
    (ROADMAP, Queue 3), which its nudged runs share and the port does
    not."""
    import numpy as np
    import torch
    from paig_reproduction_tpu_torch.models import compute_losses
    net = net.double()
    batch = torch.from_numpy(np.asarray(x, np.float64))
    out = []
    for state in states:
        net.load_state_dict({k: torch.from_numpy(np.asarray(v)).double()
                             for k, v in state.items()}, strict=False)
        with torch.no_grad():
            pred, aux = net(batch)
            out.append(float(compute_losses(net, batch, pred,
                                            aux["recons_out"], aux)[0]))
    return out
