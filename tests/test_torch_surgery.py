"""The port's numpy copies of the slot-rescue surgery (``train/surgery.py``,
keyed by state_dict names) and of the spring physics identification
(``ops/identify.py``) against the JAX package's modules on the same arrays:
parameters from a JAX PhysicsNet init, converted by convert.py.

Tolerances: the surgery's installed biases and diagnostics at rtol 1e-6 /
atol 1e-6 (the same float64 numpy arithmetic, with the kernel transposed);
identification results exactly (the same numpy code on the same arrays).
"""
import jax
import numpy as np
import pytest

from paig_reproduction_tpu.models import PhysicsNet as JaxPhysicsNet
from paig_reproduction_tpu.ops import identify as jax_identify
from paig_reproduction_tpu.train import surgery as jax_surgery
from paig_reproduction_tpu_torch.convert import flax_to_state_dict
from paig_reproduction_tpu_torch.ops import identify
from paig_reproduction_tpu_torch.train import surgery

KW = dict(task="spring_color", cell_type="spring_ode_cell", seq_len=12,
          input_steps=4, pred_steps=6, autoencoder_loss=3.0, color=True,
          input_size=32 * 32)
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def params():
    """JAX params (numpy) and the port's state_dict of them (numpy)."""
    x = np.random.RandomState(0).rand(1, 12, 3, 32, 32).astype(np.float32)
    tree = jax.device_get(JaxPhysicsNet(**KW).init(jax.random.PRNGKey(3),
                                                   x)["params"])
    return tree, {k: v.numpy() for k, v in flax_to_state_dict(tree).items()}


def _port_of(tree):
    return {k: v.numpy() for k, v in flax_to_state_dict(tree).items()}


def _assert_same_params(port, jax_tree):
    ref = _port_of(jax_tree)
    assert set(port) == set(ref)
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], err_msg=k, **TOL)


def _frames(seed=1):
    """uint8 [N, T, C, H, W] frames: a static background and two moving
    coloured squares."""
    rs = np.random.RandomState(seed)
    bg = (rs.rand(32, 32, 3) * 60).astype(np.uint8)
    f = np.broadcast_to(bg, (20, 6, 32, 32, 3)).copy()
    for n in range(20):
        for t in range(6):
            for colour, (y, x) in zip(((250, 20, 20), (20, 20, 250)),
                                      rs.randint(0, 28, (2, 2))):
                f[n, t, y:y + 4, x:x + 4] = colour
    return np.ascontiguousarray(f.transpose(0, 1, 4, 2, 3))


@pytest.mark.parametrize("var", ["var_net_template", "var_net_content",
                                 "var_net_background"])
def test_var_net_forward_matches_jax(params, var):
    tree, port = params
    np.testing.assert_allclose(surgery.var_net_forward(port, var),
                               jax_surgery.var_net_forward(tree, var), **TOL)


@pytest.mark.parametrize("idx", [None, np.arange(5, 40)])
def test_set_var_net_output_matches_jax(params, idx):
    tree, port = params
    var = "var_net_template"
    n = 2 * 16 * 16 if idx is None else idx.size
    target = np.random.RandomState(2).randn(n).astype(np.float32)
    got = surgery.set_var_net_output(port, var, target, idx)
    _assert_same_params(got, jax_surgery.set_var_net_output(tree, var,
                                                            target, idx))
    out = surgery.var_net_forward(got, var)
    np.testing.assert_allclose(out if idx is None else out[idx], target,
                               rtol=1e-5, atol=1e-5)


def test_background_surgery_matches_jax(params):
    tree, port = params
    frames = _frames()
    bg = surgery.median_background(frames)
    np.testing.assert_array_equal(bg, jax_surgery.median_background(frames))
    _assert_same_params(surgery.set_background(port, bg),
                        jax_surgery.set_background(tree, bg))


@pytest.mark.parametrize("template_init", [0.0, 3.0])
def test_slot_diagnostics_match_jax(params, template_init):
    tree, port = params
    bg = surgery.median_background(_frames())
    args = (2, 16)
    np.testing.assert_allclose(
        surgery.slot_health(port, *args, template_init=template_init),
        jax_surgery.slot_health(tree, *args, template_init=template_init))
    np.testing.assert_allclose(
        surgery.slot_salience(port, *args, 3, bg,
                              template_init=template_init),
        jax_surgery.slot_salience(tree, *args, 3, bg,
                                  template_init=template_init), **TOL)
    np.testing.assert_allclose(
        surgery.slot_content_colors(port, *args, 3,
                                    template_init=template_init),
        jax_surgery.slot_content_colors(tree, *args, 3,
                                        template_init=template_init), **TOL)


@pytest.mark.parametrize("health,salience", [
    ([0.0, 100.0], None), ([200.0, 210.0], None), ([50.0, 90.0], None),
    ([44.0, 215.0], [0.3, 0.02])])
def test_select_dead_slots_matches_jax(health, salience):
    assert surgery.select_dead_slots(
        np.array(health), tmpl_px=256, salience=salience) == \
        jax_surgery.select_dead_slots(np.array(health), tmpl_px=256,
                                      salience=salience)


def test_colour_seeding_matches_jax(params):
    tree, port = params
    frames = _frames(seed=3)
    bg = surgery.median_background(frames)
    colors = surgery.object_pixel_colors(frames, bg)
    np.testing.assert_array_equal(
        colors, jax_surgery.object_pixel_colors(frames, bg))
    clusters = surgery.color_clusters(colors, 2)
    np.testing.assert_allclose(clusters,
                               jax_surgery.color_clusters(colors, 2), **TOL)
    taken = [np.array([0.1, 0.1, 0.9], np.float32)]
    for got, ref in zip(surgery.pick_seed_colors(clusters, taken, 1),
                        jax_surgery.pick_seed_colors(clusters, taken, 1)):
        np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("template_init,rgb", [
    (0.0, (0.5, 0.5, 0.5)), (3.0, (0.9, 0.1, 0.2))])
def test_rescue_slot_matches_jax(params, template_init, rgb):
    tree, port = params
    got = surgery.rescue_slot(port, 1, 2, 16, 3, radius=3.0,
                              content_rgb=rgb, template_init=template_init)
    _assert_same_params(got, jax_surgery.rescue_slot(
        tree, 1, 2, 16, 3, radius=3.0, content_rgb=rgb,
        template_init=template_init))
    # Slot 0 is untouched.
    t = surgery.var_net_forward(got, "var_net_template").reshape(2, 16, 16)
    t0 = surgery.var_net_forward(port, "var_net_template").reshape(2, 16, 16)
    np.testing.assert_allclose(t[0], t0[0], rtol=1e-5, atol=1e-5)


def _spring_encodings(n=40, seed=4, k=4.0, equil=6.0, noise=0.1):
    """[N, 10, 4] noisy positions of spring trajectories with slot
    swaps."""
    rs = np.random.RandomState(seed)
    p = np.concatenate([rs.uniform(8, 14, (n, 2)),
                        rs.uniform(18, 24, (n, 2))], 1).reshape(n, 2, 2)
    v = rs.randn(n, 2, 2)
    frames, h = [], 0.3 / 10
    for _ in range(10):
        frames.append(p.copy())
        for _ in range(10):
            d = p[:, 0] - p[:, 1]
            norm = np.linalg.norm(d, axis=-1, keepdims=True)
            f = k * (norm - 2 * equil) * d / norm
            v = v + h * np.stack([-f, f], 1)
            p = p + h * v
    enc = np.stack(frames, 1).reshape(n, 10, 4) + rs.randn(n, 10, 4) * noise
    enc[::5, 3] = enc[::5, 3][:, [2, 3, 0, 1]]
    return enc


def test_identify_matches_jax():
    enc = _spring_encodings()
    aligned = identify.align_slots(enc, 2)
    np.testing.assert_array_equal(aligned, jax_identify.align_slots(enc, 2))
    for kw in (dict(), dict(substeps=10)):
        assert identify.fit_spring_trajectory(aligned, 0.3, **kw) == \
            jax_identify.fit_spring_trajectory(aligned, 0.3, **kw)
        assert identify.spring_trajectory_error(aligned, 0.3, 3.0, 5.0,
                                                **kw) == \
            jax_identify.spring_trajectory_error(aligned, 0.3, 3.0, 5.0,
                                                 **kw)
    k, equil, _ = identify.fit_spring_trajectory(aligned, 0.3, substeps=10)
    assert abs(k - 4.0) < 0.5 and abs(equil - 6.0) < 0.5
    for value in (0.25, 0.3, 15.9, 4.0):
        assert identify.on_bounds(value, identify.SPRING_K_BOUNDS) == \
            jax_identify.on_bounds(value, jax_identify.SPRING_K_BOUNDS)
    assert identify.SPRING_E_BOUNDS == jax_identify.SPRING_E_BOUNDS


def _gravity_encodings(n=24, t=16, seed=6, g=60.0, noise=0.05):
    """[N, t, 6] noisy positions of 3-body trajectories (3bp_color's g=60,
    m=1, dt=0.5, from its generator's kind of start: a triangle of radius
    6.75-11.25 px about the centre of the 36 px frame, turning at 2 px per
    unit time) with slot swaps."""
    from paig_reproduction_tpu_torch.ops.cells import numpy_generator_gravity
    rs = np.random.RandomState(seed)
    enc = np.empty((n, t, 6))
    for i in range(n):
        a = rs.uniform(0, 2 * np.pi) + np.array([0, 2, 4]) * np.pi / 3
        r = rs.uniform(6.75, 11.25)
        p = np.stack([18 + r * np.cos(a), 18 + r * np.sin(a)], 1)
        b = a + (rs.randint(0, 2) * 2 - 1) * np.pi / 2
        v = np.stack([2 * np.cos(b), 2 * np.sin(b)], 1) + rs.rand(2) - 0.5
        for f in range(t):
            enc[i, f] = p.ravel()
            p, v = numpy_generator_gravity(p, v, g, 1.0, 0.5, 10)
    enc += rs.randn(*enc.shape) * noise
    enc[::4, 5] = enc[::4, 5][:, [2, 3, 4, 5, 0, 1]]
    return enc


def test_gravity_identify_matches_jax():
    """The gravity fits (pointwise and trajectory), the trajectory error,
    the 3-object slot alignment and the grid bounds, exactly as the JAX
    package's on the same arrays; the trajectory fit finds g*m^2 = 60."""
    enc = _gravity_encodings()
    aligned = identify.align_slots(enc, 3)
    np.testing.assert_array_equal(aligned, jax_identify.align_slots(enc, 3))
    assert identify.GRAVITY_A_BOUNDS == jax_identify.GRAVITY_A_BOUNDS
    assert identify.fit_gravity(aligned, 0.5) == \
        jax_identify.fit_gravity(aligned, 0.5)
    for kw in (dict(), dict(substeps=10)):
        assert identify.fit_gravity_trajectory(aligned, 0.5, **kw) == \
            jax_identify.fit_gravity_trajectory(aligned, 0.5, **kw)
        assert identify.gravity_trajectory_error(aligned, 0.5, 30.0,
                                                 **kw) == \
            jax_identify.gravity_trajectory_error(aligned, 0.5, 30.0, **kw)
    A, _ = identify.fit_gravity_trajectory(aligned, 0.5, substeps=10)
    assert abs(A - 60.0) < 6.0
    for value in (2.0, 2.02, 399.0, 60.0):
        assert identify.on_bounds(value, identify.GRAVITY_A_BOUNDS) == \
            jax_identify.on_bounds(value, jax_identify.GRAVITY_A_BOUNDS)
