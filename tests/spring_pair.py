"""The spring recipe's train step in both packages from one state: the
port's Trainer on the CPU and the JAX package's jitted step, shared by
``tests/test_torch_recipe_drift.py`` and ``tests/spring_loop_study.py``.

Both take ``benchmarks/spring_one5_test_log.txt``'s model as its loop
trains it before the ``--aux_on_recons`` trigger: its model flags, the
enhancers kept for the evals (``--enhancers_eval_only``), the alignment
losses off (aux scale 0), a fresh RMSprop and the recipe's LR schedule.
A start is ``"jax_init"`` (the JAX package's ``model.init`` at PRNGKey(0),
the CLI's ``--seed=0``) or the path of a JAX ``model.ckpt``, whose params
both packages load (``convert.flax_checkpoint_to_port`` for the port).
"""
import dataclasses
import os

import jax
import numpy as np
import optax
import torch

from paig_reproduction_tpu.models import PhysicsNet as JaxPhysicsNet
from paig_reproduction_tpu.models.physics_net import (
    compute_losses as jax_losses,
)
from paig_reproduction_tpu.train import optimizers as jax_opt
from paig_reproduction_tpu_torch import cli
from paig_reproduction_tpu_torch.convert import flax_checkpoint_to_port
from paig_reproduction_tpu_torch.data import iterators
from paig_reproduction_tpu_torch.tools.reference_runs import RUNS
from paig_reproduction_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SL12 = os.path.join(REPO, "data", "datasets", "spring_color",
                    "color_spring_vx8_vy8_sl12_r2_k4_e6.npz")
# The JAX package's seed-2 spring_color run after 100 plain epochs (valid
# recons 11.23, its log): undiscovered, like the port's kept arms.
SPRING_S2_100 = os.path.join(REPO, "runs", "spring_s2_100", "model.ckpt")
MODEL_FLAGS = ("--task", "--base_lr", "--autoencoder_loss", "--color",
               "--seed", "--epochs", "--pos_consistency", "--vel_anchor",
               "--learn_frame_offset", "--init_state_fit",
               "--refine_recons_pos", "--enhancers_eval_only")
ENHANCERS = ("init_state_fit", "refine_recons_pos")


def recipe_args():
    """spring_one5's argv reduced to its model, optimizer and schedule
    flags, parsed by the port's CLI (on the CPU)."""
    argv = [a for a in RUNS["spring_one5"]["argv"]
            if a.split("=")[0] in MODEL_FLAGS]
    return cli.build_parser().parse_args(argv + ["--device=cpu"])


def port_trainer(args, data_path, steps_per_epoch):
    """The port's Trainer on the CPU: the recipe's model (its initial
    weights from ``--seed``), the file at ``data_path``, a fresh RMSprop
    over the recipe's epochs and the aux losses off."""
    trainer = Trainer(cli.build_model(args, 12), device="cpu",
                      enhancers_eval_only=True)
    trainer.get_data(iterators.get_iterators(str(data_path), conv=True))
    trainer.build_optimizer(args.base_lr, "rmsprop", True,
                            epochs=args.epochs,
                            steps_per_epoch=steps_per_epoch)
    trainer.aux_warmup_steps = 1 << 30
    return trainer


def jax_models(port_model):
    """(train model without the enhancers, eval model with them) of the
    JAX package, at the port model's configuration."""
    fields = {f.name for f in dataclasses.fields(JaxPhysicsNet)}
    kw = {k: v for k, v in port_model.config.items() if k in fields}
    return (JaxPhysicsNet(**{k: v for k, v in kw.items()
                             if k not in ENHANCERS}), JaxPhysicsNet(**kw))


def _overlay(base, top):
    """``base`` with every leaf that ``top`` also holds taken from
    ``top``."""
    if not isinstance(base, dict):
        return top
    return {k: _overlay(v, top[k]) if k in top else v
            for k, v in base.items()}


def start_params(start, jax_model, x):
    """The JAX params of ``start``: the JAX init at PRNGKey(0) on the
    frames ``x``, or a JAX checkpoint's params over it (a checkpoint of a
    run without --learn_frame_offset has no ``frame_offset``: its initial
    zeros stay)."""
    init = jax.device_get(jax.jit(jax_model.init)(
        jax.random.PRNGKey(0), x[:1])["params"])
    if start == "jax_init":
        return init
    import orbax.checkpoint as ocp
    return _overlay(init, jax.device_get(ocp.PyTreeCheckpointer().restore(
        os.path.abspath(start))["params"]))


def load_port(trainer, start, params):
    """The port's trainer on ``params`` (``flax_checkpoint_to_port``'s
    conversion); asserts that every tensor arrived, and from the JAX init
    that the port's ``--seed=0`` weights are those params already."""
    state = flax_checkpoint_to_port({"params": params})["model"]
    if start == "jax_init":
        assert all(torch.equal(v.reshape(-1), state[k].reshape(-1))
                   for k, v in trainer.model.state_dict().items()
                   if k in state)
    trainer.model.load_state_dict(state)


def jax_step_fn(jax_model, args, steps_per_epoch, params):
    """(optax transform, jitted step) of the JAX package's RMSprop over the
    recipe's schedule, the aux losses off."""
    tx = jax_opt.build_optimizer(
        "rmsprop", jax_opt.lr_schedule(args.base_lr, args.epochs,
                                       steps_per_epoch, True), params)

    @jax.jit
    def step(params, opt_state, batch):
        def loss_fn(p):
            out, aux = jax_model.apply({"params": p}, batch)
            return jax_losses(jax_model, batch, out, aux["recons_out"],
                              aux_scale=0.0)
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return tx, step


def nudged(params, by):
    """``params`` with every value multiplied by ``1 + by``."""
    return jax.tree.map(lambda v: v * (1 + by), params)
