"""Parity of the port's training stack with the JAX package's: optimizers
and the LR anneal against optax, three trainer steps against the JAX
loss_fn + optax on the same index batches, the data iterators, log lines
and the CLI's flag set; and one tiny CPU run of the port's CLI.

Tolerances: optimizer updates at rtol 1e-6 (a few f32 operations per
element). Trainer losses at rtol 1e-4, the golden-test bound
(tests/test_golden.py).
"""
import io
import logging
import os

import jax
import numpy as np
import optax
import pytest
import torch

from paig_reproduction_tpu import cli as jax_cli
from paig_reproduction_tpu.data import iterators as jax_iterators
from paig_reproduction_tpu.models import PhysicsNet as JaxPhysicsNet
from paig_reproduction_tpu.models.physics_net import (
    compute_losses as jax_losses,
)
from paig_reproduction_tpu.train import optimizers as jax_opt
from paig_reproduction_tpu.utils.misc import log_metrics as jax_log_metrics
from paig_reproduction_tpu_torch import cli
from paig_reproduction_tpu_torch.convert import flax_to_state_dict
from paig_reproduction_tpu_torch.data import iterators
from paig_reproduction_tpu_torch.models import PhysicsNet
from paig_reproduction_tpu_torch.train import optimizers
from paig_reproduction_tpu_torch.train.trainer import Trainer
from paig_reproduction_tpu_torch.utils.misc import log_metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATASET = os.path.join(REPO, "data", "datasets", "spring_color",
                       "color_spring_vx8_vy8_sl12_r2_k4_e6.npz")
KW = dict(task="spring_color", cell_type="spring_ode_cell", seq_len=12,
          input_steps=4, pred_steps=6, autoencoder_loss=3.0, color=True,
          input_size=32 * 32)


def _params(seed):
    rs = np.random.RandomState(seed)
    return {"a": rs.randn(3, 4).astype(np.float32),
            "b": rs.randn(5).astype(np.float32)}


@pytest.mark.parametrize("name", ["rmsprop", "adam", "momentum", "sgd"])
def test_optimizer_matches_optax(name):
    """Three steps on the same gradients, with the /5 anneal landing on the
    third step (boundary int(0.75*2)*2 = 2)."""
    params = _params(0)
    grads = [_params(i + 1) for i in range(3)]
    schedule = jax_opt.lr_schedule(6e-4, 2, 2, True)
    tx = jax_opt.build_optimizer(name, schedule, params)
    state = tx.init(params)
    j_params = params
    for g in grads:
        updates, state = tx.update(g, state, j_params)
        j_params = optax.apply_updates(j_params, updates)

    t_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                for k, v in params.items()}
    opt = optimizers.build_optimizer(name, t_params.items(), 6e-4)
    lr_at = optimizers.lr_schedule(6e-4, 2, 2, True)
    for step, g in enumerate(grads):
        for group in opt.param_groups:
            group["lr"] = lr_at(step)
        for k, p in t_params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in params:
        np.testing.assert_allclose(t_params[k].detach().numpy(),
                                   np.asarray(j_params[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("epochs,steps_per_epoch,anneal", [
    (2, 2, True), (10, 25, True), (10, 25, False), (1, 25, True),
    (0, 25, True)])
def test_lr_schedule_matches_jax(epochs, steps_per_epoch, anneal):
    j_sched = jax_opt.lr_schedule(1e-3, epochs, steps_per_epoch, anneal)
    t_sched = optimizers.lr_schedule(1e-3, epochs, steps_per_epoch, anneal)
    for step in range(0, max(1, epochs) * steps_per_epoch + 2):
        np.testing.assert_allclose(t_sched(step), float(j_sched(step)),
                                   rtol=1e-6)


def test_frozen_params_are_not_trained():
    params = {"log_m": torch.nn.Parameter(torch.zeros(())),
              "log_g": torch.nn.Parameter(torch.zeros(()))}
    opt = optimizers.build_optimizer("rmsprop", params.items(), 1e-3)
    trained = [p for g in opt.param_groups for p in g["params"]]
    assert len(trained) == 1 and trained[0] is params["log_g"]


def _tiny_iterators(tmp_path, n_train=8, n_eval=4, dataset=DATASET):
    with np.load(dataset) as d:
        path = tmp_path / "spring_color" / os.path.basename(dataset)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, train_x=d["train_x"][:n_train],
                 valid_x=d["valid_x"][:n_eval], test_x=d["test_x"][:n_eval])
    return path


def test_three_trainer_steps_match_jax(tmp_path):
    path = _tiny_iterators(tmp_path)
    idx_batches = [np.random.RandomState(s).choice(8, 2, replace=False)
                   for s in range(3)]
    raw = iterators.get_iterators(str(path), conv=True)[0].raw_uint8

    j_model = JaxPhysicsNet(**KW)
    params = jax.jit(j_model.init)(jax.random.PRNGKey(0),
                                   raw[:1].astype(np.float32) / 255)["params"]
    tx = jax_opt.build_optimizer(
        "rmsprop", jax_opt.lr_schedule(6e-4, 2, 2, True), params)
    opt_state = tx.init(params)

    @jax.jit
    def jax_step(params, opt_state, batch):
        def loss_fn(p):
            out, aux = j_model.apply({"params": p}, batch)
            return jax_losses(j_model, batch, out, aux["recons_out"])
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    model = PhysicsNet(**KW)
    model.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    trainer = Trainer(model, device="cpu")
    trainer.get_data(iterators.get_iterators(str(path), conv=True))
    trainer.build_optimizer(6e-4, "rmsprop", True, epochs=2,
                            steps_per_epoch=2)
    for idx in idx_batches:
        batch = raw[idx].astype(np.float32) / 255.0
        params, opt_state, j_loss = jax_step(params, opt_state, batch)
        t_loss = trainer.train_step(idx)["train_loss"]
        np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-4)
    assert trainer.step == 3


def test_data_iterators_match_jax(tmp_path):
    path = str(_tiny_iterators(tmp_path))
    j_its = jax_iterators.get_iterators(path, conv=True, datapoints=6)
    t_its = iterators.get_iterators(path, conv=True, datapoints=6)
    for j_it, t_it in zip(j_its, t_its):
        np.testing.assert_array_equal(t_it.X, j_it.X)
        np.testing.assert_array_equal(t_it.raw_uint8, j_it.raw_uint8)
    assert t_its[0].num_examples == 6
    j_it = jax_iterators.DataIterator(np.arange(10), seed=3)
    t_it = iterators.DataIterator(np.arange(10), seed=3)
    for _ in range(7):
        np.testing.assert_array_equal(t_it.next_index_batch(3),
                                      j_it.next_index_batch(3))
        assert t_it.epochs_completed == j_it.epochs_completed
    np.testing.assert_array_equal(t_it.next_index_batches(3, 10),
                                  j_it.next_index_batches(3, 10))
    batch = iterators.gather_batch(
        iterators.to_device(t_its[0].raw_uint8, "cpu"), [4, 0, 2])
    np.testing.assert_array_equal(batch.numpy(), j_its[0].X[[4, 0, 2]])


def test_log_metrics_lines_match_jax():
    metrics = {"eval_recons_loss": np.float32(1.25), "train_loss": 3.5,
               "eval_pred_loss": np.float32(767.88019)}
    lines = []
    for fn in (jax_log_metrics, log_metrics):
        stream = io.StringIO()
        logger = logging.getLogger(f"test_log_metrics_{fn.__module__}")
        logger.setLevel(logging.INFO)
        handler = logging.StreamHandler(stream)
        logger.addHandler(handler)
        fn(logger, "valid - epoch=3", metrics)
        logger.removeHandler(handler)
        lines.append(stream.getvalue())
    assert lines[0] == lines[1]


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices,
                     type(a).__name__, getattr(a.type, "__name__", None),
                     a.nargs)
            for a in parser._actions}


def test_flag_set_equals_jax_plus_device():
    port = _actions(cli.build_parser())
    ref = _actions(jax_cli.build_parser())
    assert port.pop("device")[1] == "cuda"
    assert port == ref


def test_task_table_equals_jax():
    assert cli.TASK_TABLE == jax_cli.TASK_TABLE


@pytest.mark.parametrize("flag", ["--profile_dir=x", "--n_model_shards=2",
                                  "--debug_nans", "--native_loader",
                                  "--resume_remaining_epochs",
                                  "--watchdog_secs=60"])
def test_unported_flags_raise(flag):
    """No flag refuses any more: --n_model_shards and --native_loader, the
    last two, are ported (tests/test_torch_parallel.py,
    tests/test_torch_native_loader.py), the others earlier
    (tests/test_torch_watchdog.py). The CLI has no list of unported flags,
    and a model split over more processes than the run has is refused by
    the mesh, naming the flag."""
    assert not hasattr(cli, "UNSUPPORTED_FLAGS")
    args = cli.build_parser().parse_args(["--task=spring_color", flag])
    name = flag[2:].split("=")[0]
    assert getattr(args, name) != cli.build_parser().get_default(name)
    if name == "n_model_shards":
        with pytest.raises(ValueError, match="--n_model_shards=2 does not "
                                             "divide the 1 processes"):
            cli.main(["--task=spring_color", flag, "--device=cpu"])


def test_initialize_graph_wipes_save_dir(tmp_path):
    save_dir = tmp_path / "run"
    save_dir.mkdir()
    (save_dir / "stale.txt").write_text("old")
    trainer = Trainer(PhysicsNet(**KW), device="cpu")
    trainer.build_optimizer(6e-4)
    trainer.initialize_graph(str(save_dir))
    assert save_dir.is_dir() and not any(save_dir.iterdir())
    # With use_ckpt the save_dir is kept and its checkpoint restored.
    trainer.step = 7
    trainer.save()
    (save_dir / "stale.txt").write_text("old")
    fresh = Trainer(PhysicsNet(**dict(KW, seq_len=30)), device="cpu")
    fresh.build_optimizer(6e-4)
    fresh.initialize_graph(str(save_dir), use_ckpt=True)
    assert (save_dir / "stale.txt").exists() and fresh.step == 7
    for name, t in fresh.model.state_dict().items():
        torch.testing.assert_close(t, trainer.model.state_dict()[name],
                                   rtol=0, atol=0)


def test_cli_trains_on_cpu(tmp_path, monkeypatch):
    """The slice's command, at B=4 on 8 sequences (and 4 of the seq-30
    file for the test phase): log.txt holds the JAX package's k=v lines,
    losses are finite and fall."""
    _tiny_iterators(tmp_path)
    _tiny_iterators(tmp_path, dataset=DATASET.replace("_sl12_", "_sl30_"))
    monkeypatch.setenv("PAIG_VIZ_EXAMPLES", "1")
    save_dir = tmp_path / "run"
    logger = logging.getLogger("paig")
    handlers = list(logger.handlers)
    try:
        trainer, _ = cli.main([
            "--task=spring_color", "--base_lr=6e-4",
            "--autoencoder_loss=3.0", "--color", "--batch_size=4",
            "--epochs=2", "--print_interval=1", f"--data_dir={tmp_path}",
            f"--save_dir={save_dir}", "--device=cpu"])
    finally:
        for h in set(logger.handlers) - set(handlers):
            logger.removeHandler(h)
            h.close()
    assert trainer.step == 4
    log = (save_dir / "log.txt").read_text()
    losses = [float(line.split("train_loss=")[1])
              for line in log.splitlines() if "train - iter=" in line]
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    for prefix in ("valid - epoch=0 ", "valid - epoch=1 ", "valid - epoch=2 ",
                   "test - epoch=2 ", "test - epoch=0 "):
        line = next(l for l in log.splitlines() if prefix in l)
        keys = [kv.split("=")[0] for kv in line.split(prefix)[1].split()]
        assert keys == ["eval_extrap_loss", "eval_pred_loss",
                        "eval_recons_loss"]
