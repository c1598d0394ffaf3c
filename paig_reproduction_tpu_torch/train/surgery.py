"""Parameter surgery for unsupervised object-discovery rescue.

The port's numpy copy of ``paig_reproduction_tpu/train/surgery.py``, keyed
by the port's ``state_dict`` names instead of flax paths (``convert.py``
maps one onto the other). ``params`` is a dict of numpy arrays keyed as the
model's ``state_dict``; functions that change it return a new dict.

The decoder's free variables (templates, contents, background) are each
produced by a tiny MLP applied to a constant ones(1, 10) input
(``models/blocks.VariableFromNetwork``). Because the input is constant, any
target output can be installed EXACTLY by adjusting only the final layer's
bias:

    out = h @ W1.T + b1,  h = tanh(ones @ W0.T + b0)   (h is constant)
    b1[idx] := target[idx] - (h @ W1.T)[idx]

which leaves the MLP fully trainable around the installed value. On that
rest ``set_background`` (with ``median_background``, the pixelwise median
of the training frames, which for these static backgrounds is the
background), ``rescue_slot`` (a centred-disk template and a flat content
colour for one slot), and the slot diagnostics ``slot_health`` /
``slot_salience`` / ``select_dead_slots`` that choose which slots to reset.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

# Raw-logit magnitudes for installed template disks, matching the
# --template_init prior (models/physics_net.py): the decoder shifts raw
# template logits by +5/-5 (decoder.py), so +6/-6 puts the installed mask
# firmly on/off while staying in sigmoid's trainable range.
DISK_IN, DISK_OUT = 6.0, -6.0


def _hidden(params: Dict, var_name: str) -> np.ndarray:
    """The constant hidden layer tanh(ones(1, 10) @ W0.T + b0), [1, 200]."""
    return np.tanh(
        np.ones((1, 10)) @ np.asarray(params[f"{var_name}.dense.0.weight"]).T
        + np.asarray(params[f"{var_name}.dense.0.bias"]))


def var_net_forward(params: Dict, var_name: str) -> np.ndarray:
    """Exact host-side forward of a VariableFromNetwork: flat [prod].

    Mirrors blocks.VariableFromNetwork.forward (tanh MLP on ones(1, 10));
    any --template_init init_bias is NOT included (it is a constant buffer,
    not a parameter; callers installing absolute targets into a model built
    with --template_init subtract the prior themselves).
    """
    out = (_hidden(params, var_name)
           @ np.asarray(params[f"{var_name}.dense.1.weight"]).T
           + np.asarray(params[f"{var_name}.dense.1.bias"]))
    return out[0]


def set_var_net_output(params: Dict, var_name: str, target: np.ndarray,
                       idx: Optional[np.ndarray] = None) -> Dict:
    """Return params with ``var_name``'s output set EXACTLY to ``target``
    (flat) at flat indices ``idx`` (None = everywhere), via final-bias
    adjustment. Everything stays trainable."""
    name = f"{var_name}.dense.1.bias"
    wout = (_hidden(params, var_name)
            @ np.asarray(params[f"{var_name}.dense.1.weight"]).T)[0]
    old = np.asarray(params[name])
    bias = old.copy()
    target = np.asarray(target, bias.dtype).reshape(-1)
    if idx is None:
        assert target.shape == bias.shape, (target.shape, bias.shape)
        bias = target - wout
    else:
        bias[idx] = target - wout[idx]
    out = dict(params)
    out[name] = bias.astype(old.dtype)
    return out


def logit(p: np.ndarray, eps: float = 1e-3) -> np.ndarray:
    p = np.clip(np.asarray(p, np.float64), eps, 1.0 - eps)
    return np.log(p / (1.0 - p)).astype(np.float32)


def median_background(frames: np.ndarray, max_frames: int = 2000
                      ) -> np.ndarray:
    """Pixelwise temporal median -> [H, W, C] float in [0, 1].

    frames: [N, T, ...] (dataset layout) or [N, ...] per-frame, uint8 or
    float, channels-last ([H, W, C], the on-disk layout) or channels-first
    ([C, H, W], the model API layout) — disambiguated by which axis has
    size 1 or 3. For a static background with transient moving objects,
    the median over enough frames equals the background exactly wherever
    each pixel is object-free in >50% of frames — true for these
    datasets' small fast objects.
    """
    f = np.asarray(frames)
    if f.ndim == 5:
        f = f.reshape(-1, *f.shape[2:])
    assert f.ndim == 4, f.shape
    if f.shape[-1] not in (1, 3):
        assert f.shape[1] in (1, 3), f.shape
        f = f.transpose(0, 2, 3, 1)                  # CHW -> HWC
    if f.shape[0] > max_frames:
        sel = np.linspace(0, f.shape[0] - 1, max_frames).astype(int)
        f = f[sel]
    f = f.astype(np.float32)
    if f.max() > 1.5:
        f = f / 255.0
    return np.median(f, axis=0)                      # [H, W, C]


def set_background(params: Dict, bg_img: np.ndarray) -> Dict:
    """Install bg_img ([H, W, C] in [0, 1]) as the decoded background
    (the model applies sigmoid to the raw variable, physics_net.py)."""
    return set_var_net_output(params, "var_net_background",
                              logit(bg_img).reshape(-1))


def disk_template_logits(tmpl_size: int, radius: float,
                         inside: float = DISK_IN,
                         outside: float = DISK_OUT) -> np.ndarray:
    """Centered-disk raw template logits [T, T] (inside/outside values)."""
    c = (tmpl_size - 1) / 2.0
    yy, xx = np.mgrid[:tmpl_size, :tmpl_size]
    rr = np.sqrt((yy - c) ** 2 + (xx - c) ** 2)
    return np.where(rr <= radius, inside, outside).astype(np.float32)


def template_prior_logits(tmpl_size: int, template_init: float
                          ) -> np.ndarray:
    """The --template_init graph-constant prior one slot's MLP output is
    shifted by (models/physics_net.py: +6 inside radius, -6 outside);
    zeros when template_init <= 0."""
    if template_init <= 0:
        return np.zeros((tmpl_size, tmpl_size), np.float32)
    return disk_template_logits(tmpl_size, template_init,
                                inside=6.0, outside=-6.0)


def slot_health(params: Dict, n_objs: int, tmpl_size: int,
                template_init: float = 0.0) -> np.ndarray:
    """Per-slot count of decoder-VISIBLE template pixels: the composited
    mask softmaxes each warped template logit against the background's
    constant +1 (decoder.py), so a pixel contributes only where its raw
    logit exceeds ~1. A dead slot has zero such pixels (its whole
    template sits below the background logit — measured on the mnist
    dead slot: max logit 0.58 over all 1024 px).

    ``template_init`` MUST match the flag the checkpoint was trained
    with: the prior is a graph constant added on top of the MLP output
    (not a parameter), so health is judged on MLP + prior."""
    t = var_net_forward(params, "var_net_template").reshape(
        n_objs, tmpl_size, tmpl_size)
    t = t + template_prior_logits(tmpl_size, template_init)[None]
    return (t > 1.0).sum(axis=(1, 2)).astype(np.float64)


def slot_salience(params: Dict, n_objs: int, tmpl_size: int,
                  conv_ch: int, bg: np.ndarray,
                  template_init: float = 0.0) -> np.ndarray:
    """Per-slot mean L-inf distance of the decoder-visible content from
    the mean background color, in [0, 1].

    Mask mass alone misses a measured fourth stall mode (bounce_one1,
    round 5): a slot can hold a LARGE visible mask whose content is
    background-colored — it composites background over background and
    explains no object, yet ranks "healthiest" by pixel count, so the
    rescue resets the one slot that was actually tracking a ball.
    Weighting by content salience (same 0.1 L-inf residual criterion as
    ``object_pixel_colors``) classifies that slot as dead instead."""
    t = var_net_forward(params, "var_net_template").reshape(
        n_objs, tmpl_size, tmpl_size)
    t = t + template_prior_logits(tmpl_size, template_init)[None]
    w = (t > 1.0).astype(np.float32)[..., None]
    c = var_net_forward(params, "var_net_content").reshape(
        n_objs, tmpl_size, tmpl_size, conv_ch)
    c = 1.0 / (1.0 + np.exp(-c))
    bg_color = np.asarray(bg, np.float32).reshape(-1, conv_ch).mean(axis=0)
    dist = np.abs(c - bg_color[None, None, None]).max(
        axis=-1, keepdims=True)
    tot = w.sum(axis=(1, 2, 3))
    return np.where(tot > 0,
                    (dist * w).sum(axis=(1, 2, 3)) / np.maximum(tot, 1),
                    0.0).astype(np.float64)


def select_dead_slots(health: np.ndarray,
                      dead_frac: float = 0.25,
                      tmpl_px: int = 0,
                      balloon_frac: float = 0.5,
                      salience: np.ndarray = None,
                      salience_thresh: float = 0.1) -> list:
    """Which slots to rescue given ``slot_health`` output (and
    optionally ``slot_salience``, which catches the big-mask /
    background-colored-content mode mask mass cannot see).

    Three measured stall modes, three policies:

    * a slot is DEAD when its visible template mass is under
      ``dead_frac`` of the healthiest slot's (the mnist failure: one
      crisp digit, one slot at ~zero mass) — reset the dead slots.
    * every slot is BALLOONED (visible mass above ``balloon_frac`` of
      the whole template, i.e. the templates took over background duty;
      the 3bp failure, max logits ~244 across giant masks) — reset ALL
      slots. Requires ``tmpl_px`` (= tmpl_size**2); when 0 this check
      degrades to the historical reset-all.
    * otherwise (no slot dead, not all ballooned): partial discovery —
      typically one slot tracks a real object and the others sit
      diffuse (the spring_one4 failure, health [155, 229] at recons
      ~10). Resetting the healthy slot too destroys the progress the
      run DID make (measured: spring_one4 re-collapsed into the same
      attractor for 500 epochs after an all-slot reset) — reset only
      the LEAST healthy slot.

    Shared by the in-training --auto_rescue hook and the offline tool."""
    health = np.asarray(health, np.float64)
    n = health.shape[0]
    if salience is not None:
        # Salience subsumes the mask-mass ratio: a zero-mask slot scores
        # salience 0 (dead as before), while a small-but-salient slot is
        # doing real work and must NOT be reset just for being small
        # (bounce_one1: health [44, 215], the 44-px slot tracked the
        # blue ball and the 215-px slot painted black on black).
        dead = [i for i in range(n)
                if float(salience[i]) < salience_thresh]
    else:
        dead = [i for i in range(n)
                if health[i] < dead_frac * max(float(health.max()), 1.0)]
    if dead:
        return dead
    if tmpl_px <= 0 or all(h > balloon_frac * tmpl_px for h in health):
        return list(range(n))
    return [int(health.argmin())]


def object_pixel_colors(frames: np.ndarray, bg: np.ndarray,
                        thresh: float = 0.1, max_frames: int = 200
                        ) -> np.ndarray:
    """Colors of moving-object pixels -> [N, C] float in [0, 1].

    Pixels whose residual against the median background exceeds
    ``thresh`` (L-inf over channels) belong to the moving objects — the
    population the rescued slots exist to explain. Accepts the same
    frame layouts as ``median_background``."""
    f = np.asarray(frames)
    if f.ndim == 5:
        f = f.reshape(-1, *f.shape[2:])
    assert f.ndim == 4, f.shape
    if f.shape[-1] not in (1, 3):
        assert f.shape[1] in (1, 3), f.shape
        f = f.transpose(0, 2, 3, 1)
    if f.shape[0] > max_frames:
        sel = np.linspace(0, f.shape[0] - 1, max_frames).astype(int)
        f = f[sel]
    f = f.astype(np.float32)
    if f.max() > 1.5:
        f = f / 255.0
    resid = np.abs(f - np.asarray(bg, np.float32)[None])
    return f[resid.max(axis=-1) > thresh]


def color_clusters(colors: np.ndarray, k: int, iters: int = 20,
                   seed: int = 0) -> np.ndarray:
    """k-means cluster centers [k, C] of object-pixel colors.

    Tiny fixed-iteration Lloyd's with farthest-point init (deterministic
    given ``seed``): k is n_objs (single digits here), colors is at most
    a few 10^4 pixels, so host numpy is plenty."""
    colors = np.asarray(colors, np.float32)
    n = colors.shape[0]
    assert n >= k, (n, k)
    rs = np.random.RandomState(seed)
    centers = [colors[rs.randint(n)]]
    for _ in range(1, k):
        d = np.min([np.sum((colors - c) ** 2, axis=1) for c in centers],
                   axis=0)
        centers.append(colors[int(d.argmax())])
    centers = np.stack(centers)
    for _ in range(iters):
        d = np.sum((colors[:, None] - centers[None]) ** 2, axis=2)
        assign = d.argmin(axis=1)
        for j in range(k):
            sel = colors[assign == j]
            if sel.shape[0]:
                centers[j] = sel.mean(axis=0)
    return centers


def slot_content_colors(params: Dict, n_objs: int, tmpl_size: int,
                        conv_ch: int, template_init: float = 0.0
                        ) -> np.ndarray:
    """Mean decoded content color per slot [n_objs, C], weighted by the
    decoder-visible template mask (same >1 logit criterion as
    ``slot_health``); mid-gray for a slot with no visible pixels."""
    t = var_net_forward(params, "var_net_template").reshape(
        n_objs, tmpl_size, tmpl_size)
    t = t + template_prior_logits(tmpl_size, template_init)[None]
    w = (t > 1.0).astype(np.float32)[..., None]
    c = var_net_forward(params, "var_net_content").reshape(
        n_objs, tmpl_size, tmpl_size, conv_ch)
    c = 1.0 / (1.0 + np.exp(-c))
    tot = w.sum(axis=(1, 2))
    mean = np.where(tot > 0, (c * w).sum(axis=(1, 2)) / np.maximum(tot, 1),
                    0.5)
    return mean.astype(np.float32)


def pick_seed_colors(clusters: np.ndarray, taken: Sequence[np.ndarray],
                     n_needed: int) -> list:
    """Greedy seed-color assignment: each rescued slot takes the residual
    color cluster FARTHEST from every color already spoken for (healthy
    slots' current contents + seeds already handed out), so the reset
    slot starts looking like the object nobody explains — the mechanism
    the dead-slot attractor lacks (a mid-gray disk has no pull toward
    the unexplained ball; CONVERGENCE.md round-4 bounce analysis)."""
    clusters = np.asarray(clusters, np.float32)
    taken = [np.asarray(t, np.float32) for t in taken]
    out = []
    for _ in range(n_needed):
        if taken:
            d = np.min(
                [np.sum((clusters - t) ** 2, axis=1) for t in taken],
                axis=0)
            i = int(d.argmax())
        else:
            # nothing is explained yet: most saturated cluster first;
            # per-channel ptp is identically 0 for grayscale (1-channel)
            # clusters, so fall back to distance from mid-gray there —
            # "most object-like against a gray background" (ADVICE r4)
            sat = np.ptp(clusters, axis=1)
            if float(sat.max()) <= 1e-6:
                sat = np.abs(clusters - 0.5).sum(axis=1)
            i = int(sat.argmax())
        out.append(clusters[i].copy())
        taken.append(clusters[i])
    return out


def rescue_slot(params: Dict, slot: int, n_objs: int, tmpl_size: int,
                conv_ch: int, radius: float = 9.0,
                content_rgb: Sequence[float] = (0.5, 0.5, 0.5),
                template_init: float = 0.0) -> Dict:
    """Re-initialize one slot's template (centered disk) and contents
    (flat color), leaving other slots untouched. ``template_init`` must
    match the checkpoint's training flag so the installed EFFECTIVE
    logits (MLP + graph-constant prior) equal the intended disk."""
    tt = tmpl_size * tmpl_size
    tmpl_idx = np.arange(slot * tt, (slot + 1) * tt)
    target = (disk_template_logits(tmpl_size, radius)
              - template_prior_logits(tmpl_size, template_init))
    params = set_var_net_output(
        params, "var_net_template", target.reshape(-1), tmpl_idx)
    ctt = tt * conv_ch
    cont_idx = np.arange(slot * ctt, (slot + 1) * ctt)
    rgb = np.asarray(content_rgb, np.float32).reshape(-1)
    # Broadcast a single gray level to the model's channel count;
    # anything else must match exactly (a silent 3-on-1 mismatch would
    # scatter the wrong layout into the content head — ADVICE r4).
    if rgb.size == 1 and conv_ch > 1:
        rgb = np.full(conv_ch, float(rgb[0]), np.float32)
    assert rgb.size == conv_ch, (rgb.size, conv_ch)
    content = np.tile(logit(rgb)[None], (tt, 1)).reshape(-1)
    params = set_var_net_output(params, "var_net_content", content,
                                cont_idx)
    return params
