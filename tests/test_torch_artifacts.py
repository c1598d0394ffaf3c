"""The port's run artifacts against the JAX package's: the visualization
forward's extras, outputs.npz and extra_outputs.npz, the gallery tiling,
code.zip, the JPEG and GIF writers (decoded by PIL here; the port itself
never imports it), and a tiny CLI run that writes every artifact.

Tolerances: extras and per-batch losses within 1e-5 absolute plus 1e-4
relative of the JAX package's (float32; the per-batch losses as
tests/test_golden.py holds them). The gallery tiling and outputs.npz
inputs are exact. A JPEG decodes within a mean error of 2 and a maximum of
40 levels (of 255) of its composite, the loss of quality-90 quantisation at
the hard edges of upscaled pixels; a GIF frame decodes within 25 levels, half
a step of the 6-level palette, and its palette indices exactly.
"""
import logging
import os
import zipfile

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from paig_reproduction_tpu.data import iterators as jax_iterators
from paig_reproduction_tpu.models import PhysicsNet as JaxPhysicsNet
from paig_reproduction_tpu.train import trainer as jax_trainer_mod
from paig_reproduction_tpu.utils import misc as jax_misc
from paig_reproduction_tpu.utils import viz as jax_viz
from paig_reproduction_tpu_torch import cli
from paig_reproduction_tpu_torch.convert import flax_to_state_dict
from paig_reproduction_tpu_torch.data import iterators
from paig_reproduction_tpu_torch.models import PhysicsNet
from paig_reproduction_tpu_torch.ops.cuda import st_decoder as tkernel
from paig_reproduction_tpu_torch.train import trainer as trainer_mod
from paig_reproduction_tpu_torch.utils import misc, viz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data", "datasets", "spring_color")
SL12 = os.path.join(DATA, "color_spring_vx8_vy8_sl12_r2_k4_e6.npz")
SL30 = os.path.join(DATA, "color_spring_vx8_vy8_sl30_r2_k4_e6.npz")
KW = dict(task="spring_color", cell_type="spring_ode_cell", seq_len=12,
          input_steps=4, pred_steps=6, autoencoder_loss=3.0, color=True,
          input_size=32 * 32)
EXTRAS = ("contents", "templates", "background_content", "transf_contents",
          "transf_masks", "enc_masks", "masked_objs")
ARTIFACTS = ("log.txt", "code.zip", "model.ckpt", "outputs.npz",
             "extra_outputs.npz", "example0.jpg", "templates.jpg")


def _tiny_file(dst_dir, src, n_train=8, n_eval=4):
    with np.load(src) as d:
        path = os.path.join(dst_dir, "spring_color", os.path.basename(src))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.savez(path, train_x=d["train_x"][:n_train],
                 valid_x=d["valid_x"][:n_eval], test_x=d["test_x"][:n_eval])
    return path


@pytest.fixture(scope="module")
def jax_params():
    """The JAX model's initial weights (PRNGKey 0)."""
    with np.load(SL12) as d:
        x = d["train_x"][:1]
    inp = np.transpose(x, (0, 1, 4, 2, 3)).astype(np.float32) / 255.0
    return jax.jit(JaxPhysicsNet(**KW).init)(jax.random.PRNGKey(0),
                                             inp)["params"]


def _port_model(params):
    model = PhysicsNet(**KW)
    model.load_state_dict(flax_to_state_dict(jax.device_get(params)),
                          strict=True)
    return model


def test_with_extras_matches_jax(jax_params, monkeypatch):
    """Every key, shape and value of the extras; the outputs themselves
    still go through the kernel's wrapper (twice: reconstructions and
    rollout), the extras through the plain decode."""
    with np.load(SL12) as d:
        x = d["test_x"][:3]
    inp = np.transpose(x, (0, 1, 4, 2, 3)).astype(np.float32) / 255.0
    apply = jax.jit(JaxPhysicsNet(**KW).apply,
                    static_argnames="with_extras")
    _, j_aux = apply({"params": jax_params}, inp, with_extras=True)
    fused = tkernel.st_decode_fused
    calls = []
    monkeypatch.setattr(tkernel, "st_decode_fused",
                        lambda *a: calls.append(1) or fused(*a))
    with torch.no_grad():
        _, aux = _port_model(jax_params)(torch.from_numpy(inp),
                                         with_extras=True)
    assert len(calls) == 2
    assert list(aux["extras"]) == list(EXTRAS)
    assert set(j_aux["extras"]) == set(EXTRAS)
    for k in EXTRAS:
        want = np.asarray(j_aux["extras"][k])
        got = aux["extras"][k].numpy()
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.fixture(scope="module")
def eval_artifacts(jax_params, tmp_path_factory):
    """One valid eval by each package's Trainer on the same 8 sequences,
    with the same weights and the same shuffles: their save_dirs. (The
    JAX package's visualization needs at least $PAIG_VIZ_EXAMPLES = 8 test
    sequences.)"""
    root = tmp_path_factory.mktemp("evals")
    path = _tiny_file(str(root), SL12, n_eval=8)
    dirs = {}
    for name in ("jax", "port"):
        np.random.seed(0)
        if name == "jax":
            trainer = jax_trainer_mod.Trainer(JaxPhysicsNet(**KW))
            trainer.get_data(jax_iterators.get_iterators(path, conv=True))
            trainer.params = jax_params
            trainer.build_optimizer(6e-4)
        else:
            trainer = trainer_mod.Trainer(_port_model(jax_params),
                                          device="cpu")
            trainer.get_data(iterators.get_iterators(path, conv=True))
            trainer.build_optimizer(6e-4)
        dirs[name] = str(root / name)
        trainer.initialize_graph(dirs[name], False)
        np.random.seed(1)
        trainer.eval_performance(4, type="valid")
        trainer.flush_artifacts()
    return dirs


@pytest.mark.parametrize("artifact", ["outputs.npz", "extra_outputs.npz"])
def test_npz_artifacts_match_jax(eval_artifacts, artifact):
    """The members, shapes and values of the JAX package's file for the
    same split: outputs.npz's evaluated inputs (exact) and per-batch
    losses; extra_outputs.npz's visualization tensors."""
    with np.load(os.path.join(eval_artifacts["jax"], artifact)) as want, \
            np.load(os.path.join(eval_artifacts["port"], artifact)) as got:
        assert list(got) == list(want)
        for k in want:
            assert got[k].shape == want[k].shape, k
            assert got[k].dtype == want[k].dtype, k
            if k == "input":
                np.testing.assert_array_equal(got[k], want[k])
            else:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                           atol=1e-5, err_msg=k)


def test_visualization_files_are_written(eval_artifacts):
    names = sorted(os.listdir(eval_artifacts["port"]))
    assert names == sorted(os.listdir(eval_artifacts["jax"]))
    for name in names:
        with open(os.path.join(eval_artifacts["port"], name), "rb") as f:
            head = f.read(6)
        if name.endswith(".jpg"):
            assert head[:2] == b"\xff\xd8"
        if name.endswith(".gif"):
            assert head == b"GIF89a"


@pytest.mark.parametrize("n,ncols,ch", [(36, 12, 3), (90, 30, 3), (4, 2, 3),
                                        (36, 12, 1)])
def test_gallery_equals_jax(n, ncols, ch):
    frames = np.random.RandomState(n).rand(n, 32, 32, ch)
    np.testing.assert_array_equal(viz.gallery(frames, ncols),
                                  jax_viz.gallery(frames, ncols))


def _composite(ch):
    """A gallery of dataset frames, as example%d.jpg composites them."""
    with np.load(SL12) as d:
        frames = d["test_x"][:3].reshape(36, 32, 32, 3) / 255.0
    if ch == 1:
        frames = frames.mean(axis=-1, keepdims=True)
    return viz.gallery(frames, 12)


@pytest.mark.parametrize("ch", [3, 1])
def test_jpeg_decodes_to_its_composite(tmp_path, ch):
    """save_image's JPEG, decoded by PIL, against the upscaled composite;
    a grey composite stays one grey component."""
    comp = _composite(ch)
    viz.save_image(str(tmp_path / "x.jpg"), comp)
    img = Image.open(tmp_path / "x.jpg")
    assert img.mode == ("RGB" if ch == 3 else "L")
    want = np.round(comp * 255)
    want = np.repeat(np.repeat(want, viz.IMAGE_SCALE, 0), viz.IMAGE_SCALE, 1)
    err = np.abs(np.asarray(img, np.float64) - want.reshape(
        want.shape[:2] + ((3,) if ch == 3 else ())))
    assert err.mean() < 2.0 and err.max() <= 40, (err.mean(), err.max())


def _tables(path):
    """The DQT and DHT segment payloads of a JPEG, by table id."""
    data = open(path, "rb").read()
    i, tables = 2, {}
    while data[i + 1] != 0xDA:
        length = int.from_bytes(data[i + 2:i + 4], "big")
        if data[i + 1] in (0xDB, 0xC4):
            payload = data[i + 4:i + 2 + length]
            tables[(data[i + 1], payload[0])] = payload[1:]
        i += 2 + length
    return tables


def test_jpeg_tables_are_the_standard_ones(tmp_path):
    """The quantisation tables at quality 90 and the Huffman tables equal
    the ones PIL's libjpeg writes for the same quality at 4:4:4."""
    rgb = (np.random.RandomState(0).rand(16, 16, 3) * 255).astype(np.uint8)
    viz.write_jpeg(str(tmp_path / "port.jpg"), rgb)
    Image.fromarray(rgb).save(tmp_path / "pil.jpg",
                              quality=viz.JPEG_QUALITY, subsampling=0)
    assert _tables(tmp_path / "port.jpg") == _tables(tmp_path / "pil.jpg")


@pytest.mark.parametrize("t,h,w,scale", [(12, 68, 136, 3), (3, 40, 50, 1.0),
                                         (2, 9, 7, 2.5)])
def test_gif_decodes_to_its_frames(tmp_path, t, h, w, scale):
    """Frame count, size, timing and loop; each frame within half a
    palette step of its input, resized by nearest neighbour."""
    frames = np.random.RandomState(t).rand(t, h, w, 3) * 300 - 20
    path = viz.gif(str(tmp_path / "a.mp4"), frames, fps=7, scale=scale)
    assert path.endswith("a.gif")
    img = Image.open(path)
    assert img.n_frames == t
    assert img.size == (int(w * scale), int(h * scale))
    assert img.info["duration"] == 140 and img.info["loop"] == 0
    for i in range(t):
        img.seek(i)
        got = np.asarray(img.convert("RGB"), np.float64)
        want = np.clip(frames[i], 0, 255).astype(np.uint8)
        want = viz._resize_nearest(want, img.size[1], img.size[0])
        assert np.abs(got - want).max() <= 25


def test_gif_lzw_round_trips_indices(tmp_path):
    """Random palette indices fill the LZW table several times over (every
    code width, and the clear at 4096 codes): PIL reads back every index,
    as its palette colour (the 216 colours are distinct)."""
    levels = np.arange(6) * 51
    idx = np.random.RandomState(0).randint(0, 216, size=(2, 120, 160))
    rgb = np.stack([levels[idx // 36], levels[idx // 6 % 6],
                    levels[idx % 6]], axis=-1)
    img = Image.open(viz.gif(str(tmp_path / "a.gif"), rgb))
    for i in range(2):
        img.seek(i)
        np.testing.assert_array_equal(np.asarray(img.convert("RGB")), rgb[i])


def test_code_zip_holds_the_jax_paths(tmp_path):
    """The port's trainer snapshots the same root as the JAX trainer, under
    the same relative names."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_misc.zipdir(jax_trainer_mod.root_path, str(tmp_path / "jax"))
    misc.zipdir(trainer_mod.root_path, str(tmp_path / "port"))
    names = [zipfile.ZipFile(tmp_path / d / "code.zip").namelist()
             for d in ("jax", "port")]
    assert names[0] == names[1]
    assert "../paig_reproduction_tpu_torch/cli.py" in names[1]


def test_cli_writes_every_artifact_and_resumes(tmp_path, monkeypatch):
    """Train, save, seq-30 test phase and artifacts on a tiny sl12+sl30
    pair; a rerun with --use_ckpt keeps save_dir and resumes the step."""
    for src in (SL12, SL30):
        _tiny_file(str(tmp_path), src)
    monkeypatch.setenv("PAIG_VIZ_EXAMPLES", "2")
    save_dir = tmp_path / "run"
    argv = ["--task=spring_color", "--base_lr=6e-4", "--autoencoder_loss=3.0",
            "--color", "--batch_size=4", "--epochs=2", "--print_interval=1",
            "--save_every_n_epochs=1", f"--data_dir={tmp_path}",
            f"--save_dir={save_dir}", "--device=cpu"]
    logger = logging.getLogger("paig")
    handlers = list(logger.handlers)
    try:
        trainer, test_trainer = cli.main(argv)
        assert trainer.step == 4 and test_trainer.step == 4
        for name in ARTIFACTS + ("animation1.gif", "example1.jpg"):
            assert (save_dir / name).stat().st_size > 0, name
        log = (save_dir / "log.txt").read_text()
        line = next(l for l in log.splitlines() if "test - epoch=0 " in l)
        assert all(np.isfinite(float(kv.split("=")[1]))
                   for kv in line.split("test - epoch=0 ")[1].split())

        (save_dir / "marker.txt").write_text("kept")
        trainer, test_trainer = cli.main(argv[:-4] + [
            "--epochs=1", "--use_ckpt", f"--data_dir={tmp_path}",
            f"--save_dir={save_dir}", "--device=cpu"])
    finally:
        for h in set(logger.handlers) - set(handlers):
            logger.removeHandler(h)
            h.close()
    assert (save_dir / "marker.txt").read_text() == "kept"
    assert trainer.step == 6 and test_trainer.step == 6
    assert (save_dir / "log.txt").read_text().startswith(log)
