"""Offline dataset generators of the tasks' video files, in numpy.

Counterpart of ``paig_reproduction_tpu/data/generators.py``: the four
generators the presets of ``data/generate.py`` use,
``generate_spring_balls_dataset`` (spring_color, spring_color_half),
``generate_spring_mnist_dataset`` (mnist_spring_color),
``generate_3_body_problem_dataset`` (3bp_color) and
``generate_bouncing_balls_video_dataset`` (bouncing_balls), and the three no
task reads, ``generate_bouncing_ball_dataset`` (coordinates only),
``generate_falling_ball_dataset`` and
``generate_falling_bouncing_ball_dataset``. Each seeds and
draws from the global ``np.random`` stream in the same order as the JAX
package's, with the same float64 arithmetic, so the same seed gives the same
bytes. Balls are rendered at 10x supersampling with a numpy disk rasterizer
and box-downscaled; digits come from ``data/assets.py``.

The sample gallery beside each file (``<name>_samples.jpg``) is the first
10 sequences tiled by ``utils.viz.gallery`` and written by the port's own
JPEG writer at the frames' resolution (the JAX package draws it through
matplotlib).
"""
from __future__ import annotations

import os
from itertools import combinations

import numpy as np

from paig_reproduction_tpu_torch.data.assets import (
    load_cifar_images,
    load_mnist_digits,
)
from paig_reproduction_tpu_torch.ops.cells import (
    numpy_generator_gravity,
    numpy_generator_spring,
)
from paig_reproduction_tpu_torch.utils.viz import gallery, write_jpeg

# ----- rendering helpers ---------------------------------------------------


def _disk(shape, r0, c0, radius):
    """Row/col index arrays of the pixels strictly inside the disk, in row
    order (tested over its bounding box only: no pixel outside it is
    inside)."""
    r_lo = max(0, int(np.floor(r0 - radius)))
    c_lo = max(0, int(np.floor(c0 - radius)))
    rr = np.arange(r_lo, max(r_lo, min(shape[0], int(np.ceil(
        r0 + radius)) + 1)))[:, None]
    cc = np.arange(c_lo, max(c_lo, min(shape[1], int(np.ceil(
        c0 + radius)) + 1)))[None, :]
    mask = (rr - r0) ** 2 + (cc - c0) ** 2 < radius ** 2
    rows, cols = np.nonzero(mask)
    return rows + r_lo, cols + c_lo


def _box_downscale(frame: np.ndarray, factor: int) -> np.ndarray:
    """Anti-aliased integer-factor downscale by box-filter averaging.
    frame: [H*f, W*f] or [H*f, W*f, C]."""
    h, w = frame.shape[0] // factor, frame.shape[1] // factor
    if frame.ndim == 2:
        return frame.reshape(h, factor, w, factor).mean(axis=(1, 3))
    c = frame.shape[2]
    return frame.reshape(h, factor, w, factor, c).mean(axis=(1, 3))


def _bilinear_resize(img: np.ndarray, out_hw) -> np.ndarray:
    """Half-pixel bilinear resize of a float image [H, W] or [H, W, C]."""
    h_in, w_in = img.shape[:2]
    h_out, w_out = out_hw
    ys = (np.arange(h_out) + 0.5) * h_in / h_out - 0.5
    xs = (np.arange(w_out) + 0.5) * w_in / w_out - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h_in - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w_in - 1)
    y1 = np.clip(y0 + 1, 0, h_in - 1)
    x1 = np.clip(x0 + 1, 0, w_in - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None]
    wx = np.clip(xs - x0, 0, 1)[None, :]
    if img.ndim == 3:
        wy = wy[..., None]
        wx = wx[..., None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def _save_dataset(dest, sequences, train_n, valid_n, sample_gallery=True):
    """The npz with keys train_x / valid_x / test_x, and the sample
    gallery (of frames; coordinate files have none)."""
    os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
    np.savez_compressed(
        dest,
        train_x=sequences[:train_n],
        valid_x=sequences[train_n:train_n + valid_n],
        test_x=sequences[train_n + valid_n:])
    print("Saved to file %s" % dest)
    if sample_gallery:
        _save_samples_jpg(dest, sequences)


def _save_samples_jpg(dest, sequences, n=10):
    """The first n sequences, one row each, as ``<dest>_samples.jpg``."""
    n = min(n, sequences.shape[0])
    result = gallery(np.concatenate(sequences[:n] / 255.0),
                     ncols=sequences.shape[1])
    write_jpeg(dest.rsplit(".", 1)[0] + "_samples.jpg",
               np.round(np.clip(result, 0.0, 1.0) * 255).astype(np.uint8))


# ----- collisions ----------------------------------------------------------


def compute_wall_collision(pos, vel, radius, img_size):
    """Reflect a ball that touches a wall, in place; returns (pos, vel)."""
    if pos[1] - radius <= 0:
        vel[1] = -vel[1]
        pos[1] = -(pos[1] - radius) + radius
    if pos[1] + radius >= img_size[1]:
        vel[1] = -vel[1]
        pos[1] = img_size[1] - (pos[1] + radius - img_size[1]) - radius
    if pos[0] - radius <= 0:
        vel[0] = -vel[0]
        pos[0] = -(pos[0] - radius) + radius
    if pos[0] + radius >= img_size[0]:
        vel[0] = -vel[0]
        pos[0] = img_size[0] - (pos[0] + radius - img_size[0]) - radius
    return pos, vel


def verify_wall_collision(pos, vel, radius, img_size):
    del vel
    return bool(pos[1] - radius <= 0 or pos[1] + radius >= img_size[1]
                or pos[0] - radius <= 0 or pos[0] + radius >= img_size[0])


def verify_object_collision(poss, radius):
    for pos1, pos2 in combinations(poss, 2):
        if np.linalg.norm(np.asarray(pos1) - np.asarray(pos2)) <= radius:
            return True
    return False


# ----- frames --------------------------------------------------------------


def _render_balls(poss, radius, img_size, scale, color, background=None):
    """Balls at `scale`x supersampling, box-downscaled to img_size, as
    uint8. Ball j takes colour channel 2-j."""
    scaled = [img_size[0] * scale, img_size[1] * scale]
    ch = 3 if color else 1
    if background is not None:
        frame = np.repeat(background[:, :, None], ch, axis=2) \
            if background.ndim == 2 else background.copy()
    else:
        frame = np.zeros(scaled + [ch], dtype=np.float32)
    for j, pos in enumerate(poss):
        rr, cc = _disk(scaled, int(pos[1] * scale), int(pos[0] * scale),
                       radius * scale)
        frame[rr, cc, (2 - j) if color else 0] = 1.0
    frame = _box_downscale(frame, scale)
    return (frame * 255).astype(np.uint8)


def _cifar_image(img, scaled_img_size, color=False):
    """A darkened CIFAR image ``img`` [32, 32, 3] (grey unless `color`)
    blown up to the supersampled canvas."""
    img = img.astype(np.float32)
    if not color:
        gray = np.dot(img[..., :3], [0.299, 0.587, 0.114]) / 255.0
        gray = _bilinear_resize(gray, scaled_img_size)
        return np.clip(gray - 0.2, 0.0, 1.0)
    rgb = _bilinear_resize(img / 255.0, scaled_img_size)
    return np.clip(rgb - 0.2, 0.0, 1.0)


def _cifar_background(scaled_img_size, rng, color=False):
    """``_cifar_image`` of a CIFAR image whose index it draws from
    `rng`."""
    imgs = load_cifar_images()
    return _cifar_image(imgs[rng.randint(len(imgs))], scaled_img_size, color)


def _generate(generate_sequence, total):
    sequences = []
    for i in range(total):
        if i % 100 == 0:
            print(i)
        sequences.append(generate_sequence())
    return np.array(sequences, dtype=np.uint8)


def _spring_start(img_size, radius, equil, vx0_max, vy0_max):
    """A spring pair's initial positions and velocities, drawn from the
    global stream: the centre of mass, the pair's angle and stretch, then
    each ball's velocity angle."""
    cm_pos = np.random.rand(2)
    cm_pos[0] = radius + equil + \
        (img_size[0] - 2 * (radius + equil)) * cm_pos[0]
    cm_pos[1] = radius + equil + \
        (img_size[1] - 2 * (radius + equil)) * cm_pos[1]
    angle = np.random.rand() * 2 * np.pi
    r = np.random.rand() + 0.5
    poss = np.array(
        [[np.cos(angle) * equil * r + cm_pos[0],
          np.sin(angle) * equil * r + cm_pos[1]],
         [np.cos(angle + np.pi) * equil * r + cm_pos[0],
          np.sin(angle + np.pi) * equil * r + cm_pos[1]]])
    angles = np.random.rand(2) * 2 * np.pi
    vels = np.array(
        [[np.cos(angles[0]) * vx0_max, np.sin(angles[0]) * vy0_max],
         [np.cos(angles[1]) * vx0_max, np.sin(angles[1]) * vy0_max]])
    return poss, vels


# ----- generators ----------------------------------------------------------


def generate_bouncing_ball_dataset(dest, train_set_size, valid_set_size,
                                   test_set_size, seq_len, box_size):
    """Coordinate-only single-ball bounce trajectories, float64
    ``[N, seq_len, 2]``."""
    np.random.seed(0)

    def verify_collision(x, v):
        if x[0] + v[0] > box_size or x[0] + v[0] < 0.0:
            v[0] = -v[0]
        if x[1] + v[1] > box_size or x[1] + v[1] < 0.0:
            v[1] = -v[1]
        return v

    def generate_trajectory(steps):
        traj = []
        x = np.random.rand(2) * box_size
        speed = np.random.rand() + 1
        angle = np.random.rand() * 2 * np.pi
        v = np.array([speed * np.cos(angle), speed * np.sin(angle)])
        for _ in range(steps):
            traj.append(x)
            v = verify_collision(x, v)
            x = x + v
        return traj

    total = train_set_size + valid_set_size + test_set_size
    trajectories = np.array([generate_trajectory(seq_len)
                             for _ in range(total)])
    _save_dataset(dest, trajectories, train_set_size, valid_set_size,
                  sample_gallery=False)


def generate_falling_ball_dataset(dest, train_set_size, valid_set_size,
                                  test_set_size, seq_len, img_size=None,
                                  radius=3, dt=0.15, g=9.8, ode_steps=10):
    """A single ball in free fall, drawn without supersampling."""
    np.random.seed(0)
    if img_size is None:
        img_size = [32, 32]

    def generate_sequence():
        seq = []
        pos = np.random.rand(2)
        pos[0] = radius + (img_size[0] - 2 * radius) * pos[0]
        pos[1] = radius + (img_size[1] - 2 * radius) / 2 * pos[1]
        vel = np.array([0.0, 0.0])
        for _ in range(seq_len):
            if not pos[1] + radius < img_size[1]:
                raise ValueError("the ball fell out of the frame: shorten "
                                 "seq_len or dt")
            frame = np.zeros(list(img_size) + [1], dtype=np.uint8)
            rr, cc = _disk(img_size, int(pos[1]), int(pos[0]), radius)
            frame[rr, cc, 0] = 255
            seq.append(frame)
            for _ in range(ode_steps):
                vel[1] = vel[1] + dt / ode_steps * g
                pos[1] = pos[1] + dt / ode_steps * vel[1]
        return seq

    total = train_set_size + valid_set_size + test_set_size
    _save_dataset(dest, _generate(generate_sequence, total), train_set_size,
                  valid_set_size)


def generate_falling_bouncing_ball_dataset(
        dest, train_set_size, valid_set_size, test_set_size, seq_len,
        img_size=None, radius=3, dt=0.30, g=9.8, vx0_max=0.0, vy0_max=0.0,
        cifar_background=False, ode_steps=10):
    """A single grey ball under gravity that bounces off the walls."""
    np.random.seed(0)
    rng = np.random
    if img_size is None:
        img_size = [32, 32]
    scale = 10
    scaled = [img_size[0] * scale, img_size[1] * scale]

    def generate_sequence():
        seq = []
        pos = np.random.rand(2)
        pos[0] = radius + (img_size[0] - 2 * radius) * pos[0]
        if g == 0.0:
            pos[1] = radius + (img_size[1] - 2 * radius) * pos[1]
        else:
            pos[1] = radius + (img_size[1] - 2 * radius) / 2 * pos[1]
        angle = np.random.rand() * 2 * np.pi
        vel = np.array([np.cos(angle) * vx0_max, np.sin(angle) * vy0_max])
        bg = _cifar_background(scaled, rng) if cifar_background else None
        for _ in range(seq_len):
            frame = bg.copy() if bg is not None else \
                np.zeros(scaled, dtype=np.float32)
            rr, cc = _disk(scaled, int(pos[1] * scale), int(pos[0] * scale),
                           radius * scale)
            frame[rr, cc] = 1.0
            frame = _box_downscale(frame, scale)
            seq.append((frame[:, :, None] * 255).astype(np.uint8))
            for _ in range(ode_steps):
                vel[1] = vel[1] + dt / ode_steps * g
                pos[1] = pos[1] + dt / ode_steps * vel[1]
                pos[0] = pos[0] + dt / ode_steps * vel[0]
                pos, vel = compute_wall_collision(pos, vel, radius, img_size)
        return seq

    total = train_set_size + valid_set_size + test_set_size
    _save_dataset(dest, _generate(generate_sequence, total), train_set_size,
                  valid_set_size)


def _spring_trajectory(seq_len, img_size, radius, wall_radius, equil, k,
                       dt, ode_steps, vx0_max, vy0_max, draw=None):
    """One spring sequence's ball positions [seq_len, 2, 2], rejection-
    sampled until no ball touches a wall (at ``wall_radius``) over the
    sequence and the ``ode_steps`` substeps after its last frame; with
    ``draw``, what it drew from the global stream after each attempt's
    start (the attempt's background), else None. The stream is drawn in
    the order of a generator that renders each frame as it goes: rendering
    draws nothing, so the frames can be rendered afterwards."""
    while True:
        poss, vels = _spring_start(img_size, radius, equil, vx0_max,
                                   vy0_max)
        drawn = draw() if draw is not None else None
        frames = []
        collision = False
        for _ in range(seq_len):
            frames.append(np.array(poss, dtype=np.float64))
            for _ in range(ode_steps):
                poss, vels = numpy_generator_spring(
                    poss, vels, k, equil, dt / ode_steps, 1)
                collision = (
                    verify_wall_collision(poss[0], vels[0], wall_radius,
                                          img_size)
                    or verify_wall_collision(poss[1], vels[1], wall_radius,
                                             img_size))
                if collision:
                    break
            if collision:
                break
        if not collision:
            return np.stack(frames), drawn


def _trajectories(total, **kwargs):
    """``total`` accepted ``_spring_trajectory``s in stream order: (their
    positions [total, seq_len, 2, 2], what each drew)."""
    trajs, drawn = [], []
    for i in range(total):
        if i % 100 == 0:
            print(i)
        t, d = _spring_trajectory(**kwargs)
        trajs.append(t)
        drawn.append(d)
    return np.stack(trajs), drawn


# The sequence renderer and its inputs, set before the worker processes
# fork (they inherit it) and cleared after.
_RENDER_JOB = None


def _render_range(bounds):
    render, trajs, drawn = _RENDER_JOB
    lo, hi = bounds
    return np.stack([render(trajs[i], drawn[i]) for i in range(lo, hi)])


def _render_all(render, trajs, drawn):
    """``render(positions, drawn)`` -> uint8 frames of every sequence, in
    order, as one array, over one forked process per CPU (the frames are
    those of one process: rendering is a pure function of its
    arguments)."""
    global _RENDER_JOB
    import multiprocessing
    workers = os.cpu_count() or 1
    n = len(trajs)
    step = max(1, -(-n // (4 * workers)))
    bounds = [(lo, min(n, lo + step)) for lo in range(0, n, step)]
    _RENDER_JOB = (render, trajs, drawn)
    try:
        with multiprocessing.get_context("fork").Pool(workers) as pool:
            parts = pool.map(_render_range, bounds)
    finally:
        _RENDER_JOB = None
    return np.concatenate(parts)


def generate_spring_balls_dataset(
        dest, train_set_size, valid_set_size, test_set_size, seq_len,
        img_size=None, radius=3, dt=0.3, k=3, equil=5, vx0_max=0.0,
        vy0_max=0.0, color=False, cifar_background=False, ode_steps=10,
        seed=0):
    """Two balls on a Hooke's-law spring; initial conditions are
    rejection-sampled until no wall collision occurs over the sequence.
    The trajectories are drawn first and the accepted ones rendered after,
    over one process per CPU."""
    np.random.seed(seed)
    rng = np.random
    if img_size is None:
        img_size = [32, 32]
    scale = 10
    scaled = [img_size[0] * scale, img_size[1] * scale]
    imgs = load_cifar_images() if cifar_background else None

    def render(traj, bg_index):
        bg = (_cifar_image(imgs[bg_index], scaled)
              if bg_index is not None else None)
        return np.stack([_render_balls(p, radius, img_size, scale, color,
                                       bg) for p in traj])

    total = train_set_size + valid_set_size + test_set_size
    trajs, drawn = _trajectories(
        total, seq_len=seq_len, img_size=img_size, radius=radius,
        wall_radius=radius, equil=equil, k=k, dt=dt, ode_steps=ode_steps,
        vx0_max=vx0_max, vy0_max=vy0_max,
        draw=(lambda: rng.randint(len(imgs))) if cifar_background else None)
    _save_dataset(dest, _render_all(render, trajs, drawn),
                  train_set_size, valid_set_size)


def generate_spring_mnist_dataset(
        dest, train_set_size, valid_set_size, test_set_size, seq_len,
        img_size=None, radius=3, dt=0.3, k=3, equil=5, vx0_max=0.0,
        vy0_max=0.0, color=False, cifar_background=False, ode_steps=10,
        seed=0):
    """Two MNIST digits (radius 11) on a spring over an optional static
    CIFAR background, at 5x supersampling; rejection-sampled against wall
    collisions at radius 2. The trajectories are drawn first and the
    accepted ones rendered after, over one process per CPU."""
    np.random.seed(seed)
    rng = np.random
    scale = 5
    if img_size is None:
        img_size = [32, 32]
    scaled = [img_size[0] * scale, img_size[1] * scale]

    digits_src = load_mnist_digits(2)                  # [2, 22, 22] in [0,1]
    digits = [_bilinear_resize(d, [22 * scale, 22 * scale])
              for d in digits_src]
    radius = 11

    bg_static = (_cifar_background(scaled, rng, color=color)
                 if cifar_background else None)
    ch = 3 if color else 1
    if bg_static is not None and bg_static.ndim == 2:
        bg_static = bg_static[:, :, None]

    def draw_digit(frame, j, pos):
        """Alpha-blend digit j at pos into the supersampled frame."""
        fc = np.array([
            [max(0, (pos[1] - radius) * scale),
             min(scaled[1], (pos[1] + radius) * scale)],
            [max(0, (pos[0] - radius) * scale),
             min(scaled[0], (pos[0] + radius) * scale)]])
        dc = np.array([
            [max(0, (radius - pos[1]) * scale),
             min(2 * radius * scale,
                 scaled[1] - (pos[1] - radius) * scale)],
            [max(0, (radius - pos[0]) * scale),
             min(2 * radius * scale,
                 scaled[0] - (pos[0] - radius) * scale)]])
        fc = np.round(fc).astype(np.int32)
        dc = np.round(dc).astype(np.int32)
        dslice = digits[j][dc[0, 0]:dc[0, 1], dc[1, 0]:dc[1, 1]]
        fh = fc[0, 1] - fc[0, 0]
        fw = fc[1, 1] - fc[1, 0]
        dslice = dslice[:fh, :fw]
        fh, fw = dslice.shape
        rows = slice(fc[0, 0], fc[0, 0] + fh)
        cols = slice(fc[1, 0], fc[1, 0] + fw)
        if color:
            for ell in range(3):
                fslice = frame[rows, cols, ell]
                cval = 1.0 if ell == j else 0.0
                frame[rows, cols, ell] = dslice * cval + (1 - dslice) * fslice
        else:
            fslice = frame[rows, cols, 0]
            frame[rows, cols, 0] = dslice + (1 - dslice) * fslice

    def render(traj, _):
        seq = []
        for poss in traj:
            frame = (bg_static.copy() if bg_static is not None
                     else np.zeros(scaled + [ch], dtype=np.float32))
            for j, pos in enumerate(poss):
                draw_digit(frame, j, pos)
            frame = _box_downscale(frame, scale)
            seq.append((frame * 255).astype(np.uint8))
        return np.stack(seq)

    total = train_set_size + valid_set_size + test_set_size
    trajs, drawn = _trajectories(
        total, seq_len=seq_len, img_size=img_size, radius=radius,
        wall_radius=2, equil=equil, k=k, dt=dt, ode_steps=ode_steps,
        vx0_max=vx0_max, vy0_max=vy0_max)
    _save_dataset(dest, _render_all(render, trajs, drawn),
                  train_set_size, valid_set_size)


def generate_3_body_problem_dataset(
        dest, train_set_size, valid_set_size, test_set_size, seq_len,
        img_size=None, radius=3, dt=0.3, g=9.8, m=1.0, vx0_max=0.0,
        vy0_max=0.0, color=False, cifar_background=False, ode_steps=10,
        seed=0):
    """Three bodies under mutual inverse-square gravity, starting near a
    rotating equilateral triangle; rejection-sampled against wall and
    object collisions."""
    np.random.seed(seed)
    rng = np.random
    if img_size is None:
        img_size = [32, 32]
    scale = 10
    scaled = [img_size[0] * scale, img_size[1] * scale]

    def generate_sequence():
        collision = True
        while collision:
            seq = []
            cm_pos = np.array(img_size) / 2
            angle1 = np.random.rand() * 2 * np.pi
            angle2 = angle1 + 2 * np.pi / 3 + (np.random.rand() - 0.5) / 2
            angle3 = angle1 + 4 * np.pi / 3 + (np.random.rand() - 0.5) / 2
            angles = [angle1, angle2, angle3]
            r = (np.random.rand() / 2 + 0.75) * img_size[0] / 4
            poss = np.array([[np.cos(a) * r + cm_pos[0],
                              np.sin(a) * r + cm_pos[1]] for a in angles])
            rot = np.random.randint(0, 2) * 2 - 1
            angles = [a + rot * np.pi / 2 for a in angles]
            noise = np.random.rand(2) - 0.5
            vels = np.array([[np.cos(a) * vx0_max + noise[0],
                              np.sin(a) * vy0_max + noise[1]]
                             for a in angles])
            bg = (_cifar_background(scaled, rng)
                  if cifar_background else None)
            collision = False
            for _ in range(seq_len):
                seq.append(_render_balls(poss, radius, img_size, scale,
                                         color, bg))
                for _ in range(ode_steps):
                    poss, vels = numpy_generator_gravity(
                        poss, vels, g, m, dt / ode_steps, 1)
                    collision = any(
                        verify_wall_collision(p, v, radius, img_size)
                        for p, v in zip(poss, vels)) or \
                        verify_object_collision(poss, radius + 1)
                    if collision:
                        break
                if collision:
                    break
        return seq

    total = train_set_size + valid_set_size + test_set_size
    _save_dataset(dest, _generate(generate_sequence, total), train_set_size,
                  valid_set_size)


def generate_bouncing_balls_video_dataset(
        dest, train_set_size, valid_set_size, test_set_size, seq_len,
        img_size=None, radius=2, dt=0.3, vx0_max=8.0, vy0_max=8.0,
        n_balls=2, color=True, ode_steps=10, seed=0):
    """Independently bouncing coloured balls: free flight and elastic wall
    reflection, the bouncing cell's physics."""
    np.random.seed(seed)
    if img_size is None:
        img_size = [32, 32]
    scale = 10

    def generate_sequence():
        seq = []
        poss = []
        vels = []
        for _ in range(n_balls):
            pos = np.random.rand(2)
            pos[0] = radius + (img_size[0] - 2 * radius) * pos[0]
            pos[1] = radius + (img_size[1] - 2 * radius) * pos[1]
            angle = np.random.rand() * 2 * np.pi
            poss.append(pos)
            vels.append(np.array([np.cos(angle) * vx0_max,
                                  np.sin(angle) * vy0_max]))
        poss, vels = np.array(poss), np.array(vels)
        for _ in range(seq_len):
            seq.append(_render_balls(poss, radius, img_size, scale, color))
            for _ in range(ode_steps):
                poss = poss + dt / ode_steps * vels
                for j in range(n_balls):
                    poss[j], vels[j] = compute_wall_collision(
                        poss[j], vels[j], radius, img_size)
        return seq

    total = train_set_size + valid_set_size + test_set_size
    _save_dataset(dest, _generate(generate_sequence, total), train_set_size,
                  valid_set_size)
