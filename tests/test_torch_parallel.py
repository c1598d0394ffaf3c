"""Data and tensor parallelism of the port (``parallel/distributed.py``,
``parallel/mesh.py``) on the CPU: two ``gloo`` ranks in subprocesses against
one process on the same global batch, for DP and for ``--n_model_shards=2``;
the kernels TP splits against the JAX package's ``param_shardings`` of the
same parameter tree; the global-norm clip over split kernels; a two-rank
TP run of the CLI, whose checkpoint holds whole tensors; and the
partial-``PAIG_*`` error.

Tolerances: the losses within 1e-5 relative, the gradients within 1e-4 of
the largest gradient (of the split kernels' largest, for them): the ranks
sum their partial products and gradients in another order than one
process, and the f32 rounding that moves travels through the UNet's
backward.
"""
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from paig_reproduction_tpu.models import PhysicsNet as JaxPhysicsNet
from paig_reproduction_tpu.parallel.mesh import make_mesh as jax_make_mesh
from paig_reproduction_tpu.parallel.mesh import param_shardings
from paig_reproduction_tpu_torch.convert import flax_to_state_dict
from paig_reproduction_tpu_torch.models import PhysicsNet
from paig_reproduction_tpu_torch.parallel import distributed, mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(task="spring_color", cell_type="spring_ode_cell", seq_len=6,
          input_steps=2, pred_steps=2, autoencoder_loss=3.0, color=True,
          input_size=16 * 16)
ENV = ("PAIG_COORDINATOR", "PAIG_NUM_PROCESSES", "PAIG_PROCESS_ID")

# One rank (or the one process): the gradients of one forward and backward
# on the global batch's rows of this rank, every split tensor made whole,
# and the losses, saved by rank 0.
_WORKER = r"""
import os, sys
import numpy as np
import torch
sys.path.insert(0, os.environ["PAIG_REPO"])
from paig_reproduction_tpu_torch.data.iterators import DataIterator, gather_batch
from paig_reproduction_tpu_torch.models import PhysicsNet, jax_init
from paig_reproduction_tpu_torch.parallel.distributed import init_distributed
from paig_reproduction_tpu_torch.parallel.mesh import make_mesh
from paig_reproduction_tpu_torch.train.optimizers import clip_train_group_
from paig_reproduction_tpu_torch.train.trainer import Trainer

pid = init_distributed(device="cpu")
m = make_mesh(int(os.environ["N_MODEL"]))
tr = Trainer(jax_init.load_initial_state(PhysicsNet(**{KW}),
                                         jax_init.prng_key(0)),
             device="cpu", mesh=m)
raw = np.random.RandomState(0).randint(0, 255, (8, 6, 3, 16, 16), np.uint8)
it = DataIterator(raw.astype(np.float32) / 255)
it.raw_uint8 = raw
tr.get_data((it, it, it))
tr.build_optimizer(1e-3)
idx = np.array([7, 2, 5, 0, 3, 6, 1, 4])
tr._fill_scalars(0)
losses = tr._forward_backward(
    gather_batch(tr._split_u8("train"), idx[m.rows(8)]))
grads = {{n: tr._whole(n, p.grad).clone().numpy()
          for n, p in tr.model.named_parameters() if p.grad is not None}}
# The global-norm clip, its norm summed over the split kernels' slices.
clip_train_group_(tr.optimizer, 1.0, **tr._clip_split())
clipped = {{"clip/" + n: tr._whole(n, p.grad).numpy()
            for n, p in tr.model.named_parameters() if p.grad is not None}}
if pid == 0:
    np.savez(os.environ["OUT"], losses=losses.numpy(), **grads, **clipped,
             split=np.array(sorted(tr._split)))
print("rank", pid, "done", flush=True)
""".format(KW=KW)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in ENV}
    env.update(PAIG_REPO=REPO, **extra)
    return env


def _run_ranks(code, n, out, n_model=1, args=()):
    """Runs `code` in n processes (one without the PAIG_* variables when
    n == 1); returns their outputs."""
    port = _free_port()
    procs = []
    for rank in range(n):
        extra = dict(OUT=str(out), N_MODEL=str(n_model))
        if n > 1:
            extra.update(PAIG_COORDINATOR=f"localhost:{port}",
                         PAIG_NUM_PROCESSES=str(n), PAIG_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, *args], env=_env(**extra),
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    for p in procs:
        log, _ = p.communicate(timeout=120)
        logs.append(log)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return logs


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    out = tmp_path_factory.mktemp("one") / "grads.npz"
    _run_ranks(_WORKER, 1, out)
    return dict(np.load(out))


@pytest.mark.parametrize("n_model", [1, 2], ids=["dp", "tp"])
def test_two_ranks_match_one_process(tmp_path, one_process, n_model):
    out = tmp_path / "grads.npz"
    _run_ranks(_WORKER, 2, out, n_model=n_model)
    got = dict(np.load(out))
    ref = one_process
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    names = [k for k in ref if k not in ("losses", "split")]
    assert sorted(names) == sorted(k for k in got
                                   if k not in ("losses", "split"))
    for clipped in (False, True):
        group = [k for k in names if k.startswith("clip/") == clipped]
        largest = max(np.abs(ref[k]).max() for k in group)
        for k in group:
            assert np.abs(got[k] - ref[k]).max() <= 1e-4 * largest, k
    # The clip scaled the gradients (their global norm is above 1).
    assert not np.allclose(ref["clip/encoder.dense.0.weight"],
                           ref["encoder.dense.0.weight"])
    split = list(got["split"])
    if n_model == 1:
        assert split == []
        return
    assert split == sorted(mesh.split_dims(PhysicsNet(**KW), 2))
    largest = max(np.abs(ref[k]).max() for k in split)
    for k in split:
        assert np.abs(got[k] - ref[k]).max() <= 1e-4 * largest, k


@pytest.mark.parametrize("n_model", [1, 2], ids=["dp", "tp"])
def test_spring_ranks_match_one_process_doing_their_work(tmp_path, n_model):
    """chip_smoke.py's parallel phase on the CPU at the main path's width
    (spring_color, 32 px, seq 12; B=8 on the tracked file): 2 gloo ranks
    against one process that computes the ranks' work and adds it in the
    same order, within the tolerances above. (The spring cell's gradient
    at initialization moves by 1e-3 of its largest value under any
    reordered sum, so it is not held to a plain one-process step.)"""
    sys.path.insert(0, REPO)
    import chip_smoke

    mode = "dp" if n_model == 1 else "tp"
    kw = dict(extra=("--device=cpu",), env_extra={"BATCH": "8"},
              timeout=120)
    chip_smoke.run_ranks("grads", 0, 1, str(tmp_path / "one.npz"),
                         emulate=mode, **kw)
    chip_smoke.run_ranks("grads", 2, n_model, str(tmp_path / "two.npz"),
                         backend="gloo", **kw)
    ref = dict(np.load(tmp_path / "one.npz"))
    got = dict(np.load(tmp_path / "two.npz"))
    errors = chip_smoke.parallel_errors(ref, got)
    assert errors["loss_rel"] <= 1e-5, errors
    assert errors["grad"] <= 1e-4, errors
    assert list(got["split"]) == list(ref["split"])
    if n_model == 2:
        assert errors["split_grad"] <= 1e-4, errors
        assert "encoder.dense.0.weight" in list(got["split"])


def test_spring_gradient_at_init_is_set_by_rounding(capsys):
    """Why the spring cell's ranks are held to one process that does their
    work rather than to a plain one-process step. At initialization from a
    seed whose two slots are dead (chip_smoke.DEAD_SEED; the port's own
    seed 0 was one before the CLI's --seed drew the JAX package's weights)
    the encoder gives both objects the same position, bitwise, in every
    frame
    (the spring cell's separation is exactly 0), and the gradient of the
    main path's model (float64, B=8 of the tracked file) moves by more
    than 1e-4 of its largest value when the input moves by 1e-15 and by
    1e-9, by the same amount at both, while the forward moves in
    proportion to the input. The backward through a separation of 0
    amplifies the cotangent's rounding until the per-frame cotangent clip
    of ops/cells.py bounds it, so that part of the gradient is set by
    rounding, not by the input."""
    import chip_smoke
    from paig_reproduction_tpu_torch import cli
    from paig_reproduction_tpu_torch.models.physics_net import compute_losses

    args = cli.build_parser().parse_args(
        ["--task=spring_color", "--color", "--autoencoder_loss=3.0",
         f"--seed={chip_smoke.DEAD_SEED}", "--device=cpu"])
    model = cli.build_model(args, 12).double()
    name = "color_spring_vx8_vy8_sl12_r2_k4_e6.npz"
    with np.load(os.path.join(REPO, "data", "datasets", "spring_color",
                              name)) as d:
        x = torch.from_numpy(d["train_x"][:8]).permute(0, 1, 4, 2, 3)
    x = x.double() / 255
    noise = torch.from_numpy(np.random.RandomState(1).randn(*x.shape))

    def run(inp):
        model.zero_grad(set_to_none=True)
        out, aux = model(inp)
        loss, _ = compute_losses(model, inp, out, aux["recons_out"], aux,
                                 aux_scale=0.0)
        loss.backward()
        return aux, {n: p.grad.clone() for n, p in model.named_parameters()
                     if p.grad is not None}

    aux, grads = run(x)
    pos = aux["enc_pos"].detach()
    assert torch.equal(pos[..., :2], pos[..., 2:])
    largest = max(float(g.abs().max()) for g in grads.values())
    for eps in (1e-15, 1e-9):
        aux_p, grads_p = run(x + eps * noise)
        fwd = float((aux_p["pos_vel_seq"] - aux["pos_vel_seq"]).detach()
                    .abs().max())
        moved = max(float((grads_p[n] - g).abs().max())
                    for n, g in grads.items()) / largest
        with capsys.disabled():
            print(f"\ninput moved by {eps:.0e}: rollout moved {fwd:.3e}, "
                  f"gradient moved {moved:.3e} of its largest "
                  f"({largest:.3e})")
        assert fwd < 1e3 * eps and moved > 1e-4


@pytest.mark.parametrize("task,input_size,cell", [
    ("spring_color", 32 * 32, "spring_ode_cell"),
    ("3bp_color", 36 * 36, "gravity_ode_cell"),
    ("mnist_spring_color", 64 * 64, "spring_ode_cell"),
])
def test_split_kernels_are_jax_param_shardings(task, input_size, cell):
    """The port's split dims are those of the JAX package's param_shardings
    on a ('data', 'model') = (4, 2) mesh, for the same parameter tree: each
    leaf is marked 0 (replicated), 1 (split on its first dim) or 2 (its
    second) and converted to the port's names and layouts."""
    kw = dict(task=task, cell_type=cell, seq_len=6, input_steps=2,
              pred_steps=2, color=True, input_size=input_size)
    img = int(np.sqrt(input_size))
    params = jax.eval_shape(JaxPhysicsNet(**kw).init, jax.random.PRNGKey(0),
                            np.zeros((1, 6, 3, img, img), np.float32)
                            )["params"]
    shardings = param_shardings(
        params, jax_make_mesh(n_data=4, n_model=2, devices=jax.devices()[:8]))

    def marker(leaf, sharding):
        spec = tuple(sharding.spec) + (None,) * len(leaf.shape)
        mark = next((i + 1 for i, s in enumerate(spec[:2]) if s == "model"),
                    0)
        return np.full(leaf.shape, mark, np.float32)

    marks = flax_to_state_dict(jax.tree.map(marker, params, shardings))
    port = PhysicsNet(**kw)
    got = mesh.split_dims(port, 2)
    want = {}
    for name, m in marks.items():
        mark = int(m.reshape(-1)[0]) if m.numel() else 0
        if mark:
            # flax kernel [in, out] -> the port's weight [out, in].
            want[name] = 1 if mark == 1 else 0
    assert got == want
    assert "velocity_encoder.dense.0.weight" not in got
    assert {"encoder.dense.0.weight", "var_net_background.dense.1.weight"
            } <= set(got)


_CLI = r"""
import os, sys
sys.path.insert(0, os.environ["PAIG_REPO"])
os.environ["PAIG_VIZ_EXAMPLES"] = "1"
from paig_reproduction_tpu_torch import cli
trainer, _ = cli.main(sys.argv[1:])
print("split", len(trainer._split), "step", trainer.step, flush=True)
"""


def test_cli_runs_two_tp_ranks(tmp_path):
    """The CLI on 2 gloo ranks with --n_model_shards=2, 1 epoch: every rank
    trains, the first writes log.txt and a checkpoint of whole tensors,
    and the seq-30 phase restores it into both ranks' slices."""
    data = tmp_path / "spring_color"
    data.mkdir()
    src = os.path.join(REPO, "data", "datasets", "spring_color")
    for name, n in (("color_spring_vx8_vy8_sl12_r2_k4_e6.npz", 8),
                    ("color_spring_vx8_vy8_sl30_r2_k4_e6.npz", 4)):
        with np.load(os.path.join(src, name)) as d:
            np.savez(data / name, train_x=d["train_x"][:n],
                     valid_x=d["valid_x"][:4], test_x=d["test_x"][:4])
    save_dir = tmp_path / "run"
    logs = _run_ranks(_CLI, 2, tmp_path / "unused", args=(
        "--task=spring_color", "--color", "--autoencoder_loss=3.0",
        "--batch_size=4", "--epochs=1", "--n_model_shards=2",
        "--print_interval=1", f"--data_dir={tmp_path}",
        f"--save_dir={save_dir}", "--device=cpu"))
    for log in logs:
        assert "split 9 step 2" in log
    with open(save_dir / "log.txt") as f:
        log = f.read()
    assert log.count("train - iter=") == 2
    assert "test - epoch=0 " in log
    ckpt = torch.load(save_dir / "model.ckpt", weights_only=True)
    whole = PhysicsNet(**dict(KW, input_size=32 * 32, seq_len=12,
                              input_steps=4, pred_steps=6)).state_dict()
    for name, t in whole.items():
        assert ckpt["model"][name].shape == t.shape, name
        nu = ckpt["optimizer"]["state"].get(name, {}).get("nu")
        assert nu is None or nu.shape == t.shape, name


def test_partial_env_raises(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    assert distributed.init_distributed(device="cpu") == 0
    monkeypatch.setenv("PAIG_COORDINATOR", "localhost:1")
    monkeypatch.setenv("PAIG_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="partial multi-process config"):
        distributed.init_distributed(device="cpu")


def test_rows_and_mesh_of_one_process():
    m = mesh.make_mesh(1)
    assert not m.distributed and m.shape == {"data": 1, "model": 1}
    assert m.rows(8) == slice(0, 8) and m.loss_seed == 1.0
    with pytest.raises(ValueError, match="does not divide"):
        mesh.make_mesh(2)
    two = mesh.Mesh(2, 2, rank=3)
    assert (two.data_rank, two.model_rank) == (1, 1)
    assert two.rows(8) == slice(4, 8) and two.rows(7) == slice(0, 7)
    assert distributed.process_local_rows(6) == slice(0, 6)
