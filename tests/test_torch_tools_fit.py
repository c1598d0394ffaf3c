"""The port's fit_physics and analyze_tail tools and its pointwise spring
fit against the JAX package's ``tools/fit_physics.py`` and
``tools/analyze_tail.py``.

* ``ops/identify.py::fit_spring`` against the JAX function on seeded
  spring trajectories, clean, noisy and with tied positions: equal within
  1e-10 (both float64 numpy, the same operations).
* ``encoder_positions`` on ``runs/spring500`` (restored with orbax and
  converted, as ``tests/test_torch_checkpoint.py`` does) with one batch of
  16 train sequences: the encoder positions within 1e-4 px of the JAX
  tool's on the same sequences, the rendered-appearance offsets within 1e-3
  px (a median of centroids over decoded frames), and the trajectory fit's
  k and equil within 1e-3 relative.
* ``--write``: the checkpoint holds exactly the fitted float32 values and
  every other entry as it was; a restore with ``--learn_frame_offset`` sees
  exactly those values, one without it ignores ``frame_offset`` with the
  logged notice.
* ``analyze_tail`` on ``runs/spring500`` over a 16-sequence cut of the
  sl30 test split: the same JSON keys, its values within 1e-4 relative
  (see the test for the rounding of printed values).

The JAX tools call the JAX model's ``init`` (and ``fit_physics`` its
``apply`` with extras) op by op, which compiles hundreds of tiny programs
on the CPU (about 40 s); ``jitted_jax_model`` compiles them whole instead:
the same functions of the same inputs, in about 10 s.
"""
import functools
import importlib.util
import json
import logging
import os
import re

import jax
import numpy as np
import pytest
import torch

from paig_reproduction_tpu.models import PhysicsNet as JaxPhysicsNet
from paig_reproduction_tpu_torch.convert import flax_checkpoint_to_port
from paig_reproduction_tpu_torch.models import PhysicsNet
from paig_reproduction_tpu_torch.ops import identify
from paig_reproduction_tpu_torch.tools import analyze_tail, fit_physics
from paig_reproduction_tpu_torch.train import checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data", "datasets")
SL12 = os.path.join(DATA, "spring_color",
                    "color_spring_vx8_vy8_sl12_r2_k4_e6.npz")
SPRING500 = os.path.join(REPO, "runs", "spring500")
POS_ATOL = 1e-4
OFFSET_ATOL = 1e-3
FIT_RTOL = 1e-3


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for a test's small models: more threads run
    them no faster, and beside the suite's other workers they contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def jitted_jax_model(monkeypatch):
    """The JAX model's ``init`` and ``apply`` jit-compiled, and the JAX
    tools' persistent compile cache kept in the repository's."""
    monkeypatch.setenv("PAIG_COMPILE_CACHE",
                       os.path.join(REPO, ".jax_cache"))
    init, apply = JaxPhysicsNet.init, JaxPhysicsNet.apply
    jit_init = jax.jit(lambda m, rng, x: init(m, rng, x),
                       static_argnums=0)
    jit_apply = jax.jit(
        lambda m, v, x, extras: apply(m, v, x, with_extras=extras),
        static_argnums=(0, 3))
    monkeypatch.setattr(JaxPhysicsNet, "init",
                        lambda self, rng, x: jit_init(self, rng, x))
    monkeypatch.setattr(
        JaxPhysicsNet, "apply", lambda self, v, x, with_extras=False:
        jit_apply(self, v, x, with_extras))


@pytest.fixture(scope="module")
def spring500(tmp_path_factory):
    """runs/spring500's orbax checkpoint, converted and saved as the
    port's."""
    import orbax.checkpoint as ocp
    tree = jax.device_get(ocp.PyTreeCheckpointer().restore(
        os.path.join(SPRING500, "model.ckpt")))
    d = tmp_path_factory.mktemp("spring500")
    checkpoint.save_checkpoint(str(d), flax_checkpoint_to_port(tree))
    return d


def _spring(rs, n=32, t=12, k=4.0, equil=6.0, dt=0.3, substeps=10):
    cm = rs.uniform(10, 22, (n, 1, 2))
    ang = rs.uniform(0, 2 * np.pi, (n, 1, 1))
    r = (rs.rand(n, 1, 1) + 0.5) * equil
    off = np.concatenate([np.cos(ang) * r, np.sin(ang) * r], -1)
    poss = np.concatenate([cm + off, cm - off], 1)
    vels = rs.uniform(-4, 4, (n, 2, 2))
    traj = [poss.copy()]
    h = dt / substeps
    for _ in range(t - 1):
        for _ in range(substeps):
            d = poss[:, 0] - poss[:, 1]
            norm = np.linalg.norm(d, axis=-1, keepdims=True)
            f = k * (norm - 2 * equil) * d / norm
            vels = vels + h * np.stack([-f, f], 1)
            poss = poss + h * vels
        traj.append(poss.copy())
    return np.stack(traj, 1).reshape(n, t, 4)


@pytest.mark.parametrize("case", ["clean", "noisy", "tied"])
def test_fit_spring_equals_jax(case):
    from paig_reproduction_tpu.ops import identify as jax_identify
    rs = np.random.RandomState(7)
    enc = _spring(rs)
    if case == "noisy":
        enc = enc + 0.3 * rs.randn(*enc.shape)
    elif case == "tied":
        # Both objects at one position: no separation to fit.
        enc[:, :, 2:] = enc[:, :, :2]
    ours = identify.fit_spring(enc, 0.3)
    theirs = jax_identify.fit_spring(enc, 0.3)
    np.testing.assert_allclose(ours, theirs, rtol=1e-10, atol=1e-10,
                               equal_nan=True)
    if case == "clean":
        assert abs(ours[0] - 4.0) < 0.5 and abs(ours[1] - 6.0) < 0.5


def test_encoder_positions_match_jax(spring500, jitted_jax_model):
    jax_fp = _jax_tool("fit_physics")
    np.random.seed(0)
    enc_j, model_j, _, off_j = jax_fp.encoder_positions(
        "spring_color", SPRING500, DATA, n_batches=1, batch_size=16)
    np.random.seed(0)
    enc_p, model_p, ckpt, off_p = fit_physics.encoder_positions(
        "spring_color", str(spring500), DATA, n_batches=1, batch_size=16,
        device="cpu")
    assert enc_p.shape == enc_j.shape == (16, 10, 4)
    np.testing.assert_allclose(off_p, off_j, rtol=0, atol=OFFSET_ATOL)
    np.testing.assert_allclose(enc_p - off_p, enc_j - off_j, rtol=0,
                               atol=POS_ATOL)
    kw = dict(input_steps=4, substeps=5)
    k_p, e_p, _ = identify.fit_spring_trajectory(enc_p, 0.3, **kw)
    k_j, e_j, _ = jax_fp.fit_spring_trajectory(enc_j, 0.3, **kw)
    np.testing.assert_allclose([k_p, e_p], [k_j, e_j], rtol=FIT_RTOL)
    assert model_p.cell_type == model_j.cell_type == "spring_ode_cell"
    assert ckpt["step"] == int(np.asarray(
        checkpoint.load_checkpoint(str(spring500))["step"]))


def test_write_sets_exactly_the_fitted_values(spring500, tmp_path,
                                              monkeypatch, capsys, caplog):
    ckpt_dir = tmp_path / "ckpt"
    ckpt_dir.mkdir()
    before = checkpoint.load_checkpoint(str(spring500))
    checkpoint.save_checkpoint(str(ckpt_dir), before)
    monkeypatch.setattr(fit_physics, "encoder_positions", functools.partial(
        fit_physics.encoder_positions, n_batches=1, batch_size=16))
    fitted = fit_physics.main([
        "--task", "spring_color", "--ckpt_dir", str(ckpt_dir),
        "--data_dir", DATA, "--write", "--device=cpu"])
    out = capsys.readouterr().out
    k, equil = map(float, re.search(
        r"trajectory spring fit: k=(\S+) equil=(\S+) ", out).groups())
    assert "wrote ['log_equil', 'log_k'] + frame_offset into " in out
    assert set(fitted) == {"log_k", "log_equil", "frame_offset"}
    assert abs(np.exp(fitted["log_k"]) - k) <= 5e-5 + 1e-6 * k
    assert abs(np.exp(fitted["log_equil"]) - equil) <= 5e-5 + 1e-6 * equil

    after = checkpoint.load_checkpoint(str(ckpt_dir))
    for name, value in fitted.items():
        assert after["model"][name].dtype == torch.float32
        np.testing.assert_array_equal(after["model"][name].numpy(), value)
    for name, t in before["model"].items():
        if name not in fitted:
            assert torch.equal(after["model"][name], t), name
    for name, st in before["optimizer"]["state"].items():
        for key, t in st.items():
            assert torch.equal(after["optimizer"]["state"][name][key], t)
    assert {k: v for k, v in after.items() if k not in ("model",
                                                       "optimizer")} == {
        k: v for k, v in before.items() if k not in ("model", "optimizer")}

    kw = dict(task="spring_color", cell_type="spring_ode_cell", seq_len=12,
              input_steps=4, pred_steps=6, autoencoder_loss=3.0,
              color=True, input_size=32 * 32)
    aligned = PhysicsNet(**kw, learn_frame_offset=True)
    checkpoint.restore_checkpoint(str(ckpt_dir), aligned)
    for name, value in fitted.items():
        np.testing.assert_array_equal(
            getattr(aligned, name).detach().numpy(), value)
    caplog.set_level(logging.INFO, logger="paig")
    plain = PhysicsNet(**kw)
    checkpoint.restore_checkpoint(str(ckpt_dir), plain)
    assert any("ignoring" in r.getMessage()
               and "model/frame_offset" in r.getMessage()
               for r in caplog.records)
    assert plain.log_k.item() == float(fitted["log_k"])


def _report(printed):
    """The JSON report a run of analyze_tail printed."""
    return json.loads(printed.split("saved arrays ->")[0])


def _close(a, b, rtol, unit):
    """Report values equal within ``rtol`` relative, or within one unit of
    the last printed decimal (two values that straddle a rounding edge)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(
            _close(a[k], b[k], rtol, unit) for k in a)
    return abs(a - b) <= max(rtol * abs(b), unit * 1.0001)


def test_analyze_tail_matches_jax(spring500, tmp_path, monkeypatch, capsys,
                                  jitted_jax_model):
    """The report and the per-sequence arrays on a 16-sequence cut of the
    sl30 test split: the same keys; the arrays within 1e-4 relative (of
    each array's largest value); each reported number within 1e-4 relative
    or one unit of its last printed decimal; the worst sequences' ids equal
    where their losses are more than 1e-4 apart."""
    import sys
    data = tmp_path / "sl30.npz"
    with np.load(os.path.join(DATA, "spring_color",
                              "color_spring_vx8_vy8_sl30_r2_k4_e6.npz")) as d:
        np.savez(data, test_x=d["test_x"][:16])
    argv = ["--task", "spring_color", "--data", str(data), "--batch", "8"]
    monkeypatch.setattr(sys, "argv", ["analyze_tail.py", "--ckpt_dir",
                                      SPRING500, *argv, "--out",
                                      str(tmp_path / "jax.npz")])
    _jax_tool("analyze_tail").main()
    jax_report = _report(capsys.readouterr().out)
    report = analyze_tail.main(["--ckpt_dir", str(spring500), *argv,
                                "--out", str(tmp_path / "port.npz"),
                                "--device=cpu"])
    assert _report(capsys.readouterr().out) == report
    assert list(report) == list(jax_report)
    with np.load(tmp_path / "jax.npz") as j, \
            np.load(tmp_path / "port.npz") as p:
        assert sorted(j.files) == sorted(p.files)
        for name in j.files:
            a, b = p[name], j[name]
            finite = np.isfinite(b)
            np.testing.assert_array_equal(np.isfinite(a), finite)
            scale = np.abs(b[finite]).max()
            np.testing.assert_allclose(a[finite], b[finite], rtol=0,
                                       atol=1e-4 * scale, err_msg=name)
        losses = j["pred_seq_loss"]
    for key, value in report.items():
        theirs = jax_report[key]
        if key == "worst15_ids":
            for a, b in zip(value, theirs):
                assert a == b or abs(losses[a] - losses[b]) <= \
                    1e-4 * losses.max()
        elif key.startswith("worst15_"):
            unit = 0 if key == "worst15_swap" else 0.01
            assert all(_close(a, b, 1e-4, unit)
                       for a, b in zip(value, theirs)), key
        else:
            assert _close(value, theirs, 1e-4, 0.001), key
