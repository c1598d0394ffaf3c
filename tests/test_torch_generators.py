"""The port's dataset generators (data/generators.py, data/generate.py) and
assets (data/assets.py) against the JAX package's: each preset generator's
uint8 output is byte-equal to the JAX generator's at the same seed (a few
sl12 sequences), and so are the three generators no preset uses (the
coordinate file's float64 too); the presets name the same files with the
same arguments, and the tracked digit file is the JAX package's sklearn
digits.
"""
import os

import numpy as np
import pytest

from paig_reproduction_tpu.data import assets as jax_assets
from paig_reproduction_tpu.data import generate as jax_generate
from paig_reproduction_tpu.data import generators as jax_generators
from paig_reproduction_tpu_torch.data import assets, generate, generators

TASKS = ["bouncing_balls", "3bp_color", "spring_color_half",
         "mnist_spring_color"]


@pytest.fixture
def no_mnist_cache(monkeypatch, tmp_path):
    """Neither package finds a keras MNIST cache: the JAX package falls back
    to sklearn's digits, the port to its tracked file."""
    monkeypatch.setenv("PAIG_MNIST_NPZ", str(tmp_path / "absent.npz"))
    monkeypatch.delenv("PAIG_CIFAR_NPZ", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))


@pytest.mark.parametrize("task", TASKS)
def test_generator_bytes_equal_jax(task, tmp_path, no_mnist_cache):
    (_, j_fn, j_kw), = jax_generate._presets(3, 1, 1)[task][:1]
    (rel, fn, kw), = generate.presets()[task][:1]
    assert {k: v for k, v in j_kw.items() if not k.endswith("_set_size")} \
        == kw
    j_kw = dict(j_kw, seq_len=12)
    kw = dict(kw, seq_len=12)
    j_fn(str(tmp_path / "jax.npz"), **j_kw)
    fn(str(tmp_path / "port.npz"), train_set_size=3, valid_set_size=1,
       test_set_size=1, **kw)
    with np.load(tmp_path / "jax.npz") as a, \
            np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files) == [
            "test_x", "train_x", "valid_x"]
        for key in a.files:
            assert a[key].dtype == b[key].dtype == np.uint8
            assert np.array_equal(a[key], b[key]), key
        assert b["train_x"].shape[:2] == (3, 12)
    with open(tmp_path / "port_samples.jpg", "rb") as f:
        data = f.read()
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"


@pytest.mark.parametrize("name,kw", [
    ("generate_bouncing_ball_dataset", dict(seq_len=12, box_size=32.0)),
    ("generate_falling_ball_dataset", dict(seq_len=8)),
    ("generate_falling_bouncing_ball_dataset",
     dict(seq_len=12, vx0_max=4.0, vy0_max=4.0)),
    ("generate_falling_bouncing_ball_dataset",
     dict(seq_len=6, g=0.0, cifar_background=True))],
    ids=["bouncing_coords", "falling", "falling_bouncing",
         "falling_bouncing_cifar"])
def test_unpreset_generators_equal_jax(name, kw, tmp_path, no_mnist_cache):
    sizes = dict(train_set_size=3, valid_set_size=1, test_set_size=2)
    getattr(jax_generators, name)(str(tmp_path / "jax.npz"), **sizes, **kw)
    getattr(generators, name)(str(tmp_path / "port.npz"), **sizes, **kw)
    with np.load(tmp_path / "jax.npz") as a, \
            np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files) == [
            "test_x", "train_x", "valid_x"]
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            assert a[key].tobytes() == b[key].tobytes(), key
        assert b["train_x"].shape[:2] == (3, kw["seq_len"])
    coords = name == "generate_bouncing_ball_dataset"
    assert (tmp_path / "port_samples.jpg").exists() is not coords


def test_presets_name_the_jax_files():
    jax_presets = jax_generate._presets(1, 1, 1)
    port = generate.presets()
    assert set(port) == set(jax_presets)
    for task, files in port.items():
        assert [f[0] for f in files] == [f[0] for f in jax_presets[task]]
        assert [f[1].__name__ for f in files] == \
            [f[1].__name__ for f in jax_presets[task]]


def test_generate_cli_sizes_each_file(tmp_path):
    generate.main(["--task", "bouncing_balls", "--out_dir", str(tmp_path),
                   "--train", "2", "--valid", "1", "--test", "1",
                   "--test_train", "0", "--test_valid", "0",
                   "--test_test", "2"])
    rels = [f[0] for f in generate.presets()["bouncing_balls"]]
    with np.load(tmp_path / rels[0]) as d:
        assert [d[k].shape[0] for k in ("train_x", "valid_x", "test_x")] \
            == [2, 1, 1]
    with np.load(tmp_path / rels[1]) as d:
        assert [d[k].shape[0] for k in ("train_x", "valid_x", "test_x")] \
            == [0, 0, 2]
        assert d["test_x"].shape[1] == 30


def test_digit_file_is_the_jax_sklearn_digits(no_mnist_cache):
    digits = np.load(assets.DIGITS_FILE)
    ref = jax_assets._sklearn_digits(2)
    assert digits.dtype == ref.dtype == np.float32
    assert np.array_equal(digits, ref)
    assert np.array_equal(assets.load_mnist_digits(2),
                          jax_assets.load_mnist_digits(2))
    with pytest.raises(ValueError):
        assets.load_mnist_digits(3)


def test_keras_cache_comes_first(tmp_path, monkeypatch):
    x = np.random.RandomState(0).randint(0, 256, (4, 28, 28)).astype(np.uint8)
    path = tmp_path / "mnist.npz"
    np.savez(path, x_train=x)
    monkeypatch.setenv("PAIG_MNIST_NPZ", str(path))
    got = assets.load_mnist_digits(3)
    assert np.array_equal(got, jax_assets.load_mnist_digits(3))
    assert got.shape == (3, 22, 22)


def test_noise_backgrounds_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("PAIG_CIFAR_NPZ", raising=False)
    assert np.array_equal(assets.load_cifar_images(),
                          jax_assets.load_cifar_images())
    assert os.path.exists(assets.DIGITS_FILE)
