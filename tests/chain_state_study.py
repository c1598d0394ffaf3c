"""3bp_color's chain on one trained state, in both packages (a study that
the tier-1 command does not collect).

Given a checkpoint that the port's chain wrote (``reference_runs --run
3bp_chain``: a stage's ``model.ckpt``, for example the ``fit`` stage's,
copied back from the card), it carries the model into the JAX package
(``port_to_flax``, the inverse of ``convert.flax_to_state_dict``) and
prints, for each package on the CPU:

* the test phase's losses (``benchmarks/3bp_test_log.txt``'s flags: the
  state fit, the frame offset) on the first ``--n`` sequences of the
  tracked seq-40 test split, in float64, and the rollout's start
  velocities there;
* train_loss and its gradients on 2 train sequences of the seq-20 file in
  float64 (the largest difference per tensor, relative to the JAX
  gradient's largest entry);
* ``fit_physics``'s encoder positions and its pointwise and trajectory
  gravity fits over ``--fit_batches`` batches of 100 train sequences.

    python tests/chain_state_study.py --ckpt DIR [--n 100] [--fit_batches 8]

The same state giving the same numbers in both says that the chain's
result at that stage is the state's, not a difference of the port's.
"""
import argparse
import importlib.util
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
DATA = os.path.join(REPO, "data", "datasets")
TEST_LOG = "benchmarks/3bp_test_log.txt"


def port_to_flax(state_dict) -> dict:
    """A port state_dict (no LSTM) as the JAX package's params tree of
    numpy arrays: ``convert.flax_to_state_dict`` undone."""
    tree = {}
    for name, t in state_dict.items():
        parts = name.split(".")
        path, i = [], 0
        while i < len(parts) - 1:
            p = parts[i]
            if p == "unet":
                path.append("ShallowUNet_0")
            elif p == "convs":
                path += [f"TorchConv_{parts[i + 1]}", "Conv_0"]
                i += 1
            elif p == "dense":
                path.append(f"TorchDense_{parts[i + 1]}")
                i += 1
            else:
                path.append(p)
            i += 1
        leaf, a = parts[-1], t.detach().cpu().numpy()
        if leaf == "weight":
            leaf = "kernel"
            a = a.T if a.ndim == 2 else a.transpose(2, 3, 1, 0)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.array(a)
    return tree


def _frames(rel, split, n):
    with np.load(os.path.join(DATA, rel)) as d:
        x = d[split][:n]
    return np.ascontiguousarray(np.transpose(x, (0, 1, 4, 2, 3))).astype(
        np.float64) / 255.0


def _models(argv, seq_len):
    """The port's model of the CLI flags ``argv`` at ``seq_len``, and the
    JAX package's of the same fields."""
    import dataclasses

    from paig_reproduction_tpu.models import PhysicsNet as JaxPhysicsNet
    from paig_reproduction_tpu_torch import cli
    fields = {f.name for f in dataclasses.fields(JaxPhysicsNet)}
    port = cli.build_model(cli.build_parser().parse_args(
        argv + ["--device=cpu"]), seq_len)
    return port, JaxPhysicsNet(**{k: v for k, v in port.config.items()
                                  if k in fields})


def losses_both(model_dict, argv, x, grads=False):
    """(port, JAX) float64 (train_loss, eval losses, start velocities[,
    grads by port name]) of the flags ``argv`` on frames ``x``."""
    import jax
    import jax.numpy as jnp
    import torch

    from paig_reproduction_tpu.models.physics_net import (
        compute_losses as jax_losses,
    )
    from paig_reproduction_tpu_torch.convert import flax_to_state_dict
    from paig_reproduction_tpu_torch.models import compute_losses

    port, jax_model = _models(argv, x.shape[1])
    port = port.double()
    port.load_state_dict({k: v.double() for k, v in model_dict.items()},
                         strict=True)
    xt = torch.from_numpy(x)
    out, aux = port(xt)
    tl, ev = compute_losses(port, xt, out, aux["recons_out"], aux)
    cu2 = port.coord_units // 2
    ours = [float(tl.detach()), {k: float(v) for k, v in ev.items()},
            aux["pos_vel_seq"][:, 0, cu2:].detach().numpy()]
    if grads:
        tl.backward()
        ours.append({n: p.grad.numpy() for n, p in port.named_parameters()
                     if p.grad is not None})

    with jax.enable_x64(True):
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                              port_to_flax(model_dict))
        xj = jnp.asarray(x)

        def loss(p):
            o, a = jax_model.apply({"params": p}, xj)
            t, e = jax_losses(jax_model, xj, o, a["recons_out"], a)
            return t, (e, a["pos_vel_seq"][:, 0, cu2:])
        if grads:
            (t, (e, vel)), g = jax.jit(jax.value_and_grad(
                loss, has_aux=True))(params)
        else:
            t, (e, vel) = jax.jit(loss)(params)
        theirs = [float(t), {k: float(v) for k, v in e.items()},
                  np.asarray(vel)]
        if grads:
            theirs.append({k: v.numpy() for k, v in flax_to_state_dict(
                jax.device_get(g)).items()})
    return ours, theirs


def fits_both(model_dict, n_batches):
    """(port, JAX) fit_physics on the state: (offsets, encoder positions,
    pointwise A, trajectory A), and the port's trajectory fit of the JAX
    tool's positions (the same input to both fits)."""
    import jax
    import torch

    from paig_reproduction_tpu.train.checkpoint import save_checkpoint
    from paig_reproduction_tpu_torch.ops import identify
    from paig_reproduction_tpu_torch.tools import fit_physics
    from paig_reproduction_tpu_torch.train import checkpoint

    spec = importlib.util.spec_from_file_location(
        "jax_fit_physics", os.path.join(REPO, "tools", "fit_physics.py"))
    jfp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jfp)
    tmp = tempfile.mkdtemp(prefix="chain_state_")
    os.makedirs(os.path.join(tmp, "port"))
    checkpoint.save_checkpoint(os.path.join(tmp, "port"),
                               {"model": dict(model_dict)})
    save_checkpoint(os.path.join(tmp, "jax"),
                    {"params": port_to_flax(model_dict), "step": 0})
    out = []
    for side in ("port", "jax"):
        np.random.seed(0)
        if side == "port":
            with torch.no_grad():
                enc, _, _, off = fit_physics.encoder_positions(
                    "3bp_color", os.path.join(tmp, side), DATA,
                    n_batches=n_batches, device="cpu")
            fg, fgt = identify.fit_gravity, identify.fit_gravity_trajectory
        else:
            enc, _, _, off = jfp.encoder_positions(
                "3bp_color", os.path.join(tmp, side), DATA,
                n_batches=n_batches)
            fg, fgt = jfp.fit_gravity, jfp.fit_gravity_trajectory
        out.append((off, enc, fg(enc, 0.5)[0],
                    fgt(enc, 0.5, input_steps=4, substeps=5)[0]))
        jax.clear_caches()
    same_input = identify.fit_gravity_trajectory(
        out[1][1], 0.5, input_steps=4, substeps=5)[0]
    return out, same_input


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", required=True,
                    help="a directory holding the port's model.ckpt")
    ap.add_argument("--n", type=int, default=100,
                    help="seq-40 test sequences")
    ap.add_argument("--fit_batches", type=int, default=8)
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch
    torch.set_num_threads(os.cpu_count() or 1)
    from paig_reproduction_tpu_torch import cli
    from paig_reproduction_tpu_torch.tools import reference_runs as rr
    from paig_reproduction_tpu_torch.train import checkpoint

    model = checkpoint.load_checkpoint(args.ckpt)["model"]
    flags = rr.test_flags(TEST_LOG)
    sl20, sl40 = cli.TASK_TABLE["3bp_color"][:2]

    ours, theirs = losses_both(model, flags, _frames(sl40, "test_x",
                                                     args.n))
    print(f"test phase ({TEST_LOG}'s flags, {args.n} seq-40 test "
          f"sequences, float64):")
    for k in ("eval_pred_loss", "eval_recons_loss", "eval_extrap_loss"):
        a, b = ours[1][k], theirs[1][k]
        print(f"  {k}: port {a:.6f}, JAX {b:.6f}, relative difference "
              f"{abs(a - b) / abs(b):.3e}")
    print(f"  start velocities: port's largest |v| "
          f"{np.abs(ours[2]).max():.4f}, JAX's {np.abs(theirs[2]).max():.4f}"
          f"; largest difference {np.abs(ours[2] - theirs[2]).max():.3e}; "
          f"the port's first sequence {np.round(ours[2][0], 4).tolist()}")

    train_flags = [a for a in flags if a not in ("--test_mode",
                                                 "--use_ckpt")]
    ours, theirs = losses_both(model, train_flags,
                               _frames(sl20, "train_x", 2), grads=True)
    worst = max(float(np.abs(ours[3][n] - g).max() / max(np.abs(g).max(),
                                                         1e-12))
                for n, g in theirs[3].items())
    print(f"train_loss on 2 seq-20 train sequences (float64): port "
          f"{ours[0]:.9f}, JAX {theirs[0]:.9f}; gradients: largest "
          f"difference {worst:.3e} of the JAX tensor's largest entry")

    ((o_p, e_p, a_p, t_p), (o_j, e_j, a_j, t_j)), t_same = fits_both(
        model, args.fit_batches)
    print(f"fit_physics over {args.fit_batches} x 100 train sequences: "
          f"offsets differ by {np.abs(o_p - o_j).max():.3e} px, encoder "
          f"positions by {np.abs(e_p - e_j).max():.3e} px; pointwise A "
          f"port {a_p:.4f}, JAX {a_j:.4f}; trajectory A port {t_p:.4f}, "
          f"JAX {t_j:.4f}; the port's trajectory fit of the JAX tool's "
          f"positions {t_same:.4f}")


if __name__ == "__main__":
    main()
