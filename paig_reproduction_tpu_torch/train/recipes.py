"""Single-command training recipes: the in-run machinery that turns the
discovery -> identify -> align pipeline into one invocation.

Counterpart of ``paig_reproduction_tpu/train/recipes.py``. ``RecipeMixin``
holds what ``Trainer.train_model`` consults beyond the reference loop:

* ``--discovery_restarts``  random-restart object discovery;
* ``--aux_on_recons``       staged activation of the alignment losses;
* ``--fit_physics_every``   train-time physics self-identification;
* ``--auto_rescue``         in-training slot-rescue surgery.

The reference loop itself stays in ``trainer.py``.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from paig_reproduction_tpu_torch.ops import cells, identify
from paig_reproduction_tpu_torch.train import surgery

logger = logging.getLogger("paig")

# Aux warm-up boundary while the --aux_on_recons trigger has not fired.
NEVER = 1 << 30


def arm_generator(seed: int, arm: int) -> torch.Generator:
    """The weights' generator of discovery arm ``arm``: arm 0 is the plain
    run's (``seed``), the others each draw their own seed from
    ``(seed, arm)``."""
    if arm == 0:
        return torch.Generator().manual_seed(seed)
    return torch.Generator().manual_seed(int(
        np.random.SeedSequence([seed, arm]).generate_state(1)[0]))


class RecipeMixin:
    """Recipe machinery mixed into Trainer (trainer.py). Uses the Trainer's
    model, optimizer, step, iterators, ``_make_optimizer``, ``train_step``
    or ``train_chunk`` (as its fused predicate says), ``load_whole_state``
    and ``_eval_losses``."""

    def set_aux_trigger(self, recons_threshold: float):
        """Arm the --aux_on_recons discovery trigger (after build_optimizer):
        the aux losses stay off until the first valid eval with recons below
        the threshold; the train-time physics fit waits for the same
        signal."""
        self.aux_on_recons = float(recons_threshold)
        self._aux_triggered = False
        if self.aux_on_recons > 0:
            self.aux_warmup_steps = NEVER

    # ----- discovery restarts ------------------------------------------------
    def _train_epochs_raw(self, n_epochs, batch_size):
        """Bare training for ``n_epochs`` iterator epochs: no eval, save,
        logging or trigger machinery (the discovery arms); in fused chunks
        where the trainer's predicate admits them."""
        target = self.train_iterator.epochs_completed + n_epochs
        fused = self._fused_train(batch_size)
        chunk_k = self._chunk_len()
        while self.train_iterator.epochs_completed < target:
            self._wd_pet()
            if fused:
                self.train_chunk(batch_size, chunk_k)
            else:
                self.train_step(
                    self.train_iterator.next_index_batch(batch_size))

    def _quick_valid_recons(self, batch_size) -> float:
        """Mean valid recons loss, with no artifact or visualization work
        (the arms' score)."""
        return float(self._eval_losses("valid", batch_size)[0][:, 2].mean())

    def run_discovery_restarts(self, batch_size, restarts, arm_epochs,
                               keep_going_below: float = 0.0):
        """Random-restart object discovery (--discovery_restarts).

        Trains ``restarts`` arms, each from fresh weights (its own
        ``arm_generator``), a fresh optimizer and the ongoing shuffle
        stream, for ``arm_epochs`` epochs; scores each by valid recons and
        continues the run from the best. Arm 0 is the plain run's weights,
        so one restart reproduces the plain run. A diverged (NaN) arm never
        wins. With ``keep_going_below`` > 0 the arms stop once one scores
        under it. Returns the per-arm scores."""
        self.add_train_logger()
        scores = []
        best = None                       # (recons, model state, opt, step)
        for arm in range(restarts):
            fresh = type(self.model)(**self.model.config,
                                     generator=arm_generator(self.seed, arm))
            self.load_whole_state(fresh.state_dict())
            self.optimizer = self._make_optimizer()
            self.step = self._opt_step0 = 0
            self._train_epochs_raw(arm_epochs, batch_size)
            recons = self._quick_valid_recons(batch_size)
            scores.append(recons)
            logger.info("discovery restart arm %d/%d: valid recons %.3f "
                        "after %d epochs", arm + 1, restarts, recons,
                        arm_epochs)
            if np.isfinite(recons) and (best is None or recons < best[0]):
                best = (recons, {k: v.clone() for k, v in
                                 self.model.state_dict().items()},
                        self.optimizer, self.step)
            if keep_going_below > 0 and recons < keep_going_below:
                break
        if best is None:
            logger.warning("discovery restarts: every arm diverged "
                           "(scores %s); continuing from the last arm",
                           scores)
        else:
            recons, state, self.optimizer, self.step = best
            self.model.load_state_dict(state)
        self._epochs_consumed = arm_epochs
        logger.info("discovery restarts: continuing from arm %d "
                    "(valid recons %.3f; arms %s)",
                    scores.index(best[0]) if best else len(scores) - 1,
                    best[0] if best else scores[-1],
                    ["%.2f" % s for s in scores])
        # train_model keys its epoch loop on the iterator's epoch counter,
        # which the arms advanced: rewind it.
        self.train_iterator.reset_epoch()
        return scores

    # ----- auto-rescue surgery ----------------------------------------------
    def _discovery_stalled(self, ep, recons, min_rel_improve: float = 0.05):
        """Stall guard for --auto_rescue: stalled = less than
        ``min_rel_improve`` relative improvement on the most recent valid
        eval at least auto_rescue/2 epochs back (stalled when there is
        none), so a run that is still descending is not reset."""
        lookback = max(1, self.auto_rescue // 2)
        past = [r for (e, r) in self._recons_history if e <= ep - lookback]
        if not past:
            return True
        baseline = past[-1]
        if not np.isfinite(baseline) or baseline <= 0:
            return True
        improving = (baseline - recons) / baseline >= min_rel_improve
        if improving:
            logger.info(
                "auto_rescue: deferred at epoch %d — recons %.3f still "
                "improving (%.1f%% over the last %d epochs)", ep, recons,
                100.0 * (baseline - recons) / baseline, lookback)
        return not improving

    def _do_auto_rescue(self, ep, recons):
        """In-training slot-rescue surgery (--auto_rescue; train/surgery.py,
        exact final-bias installs): dead slots (or, with none dead, the
        least healthy one; all when every slot has ballooned) are reset to
        centred-disk templates with mid-grey (or, with
        --rescue_seed_color, the unexplained colour's) contents; the
        background is pinned to the pixelwise median of the train split and
        frozen (bg_lr_mult=0); the optimizer state and the LR schedule start
        again over the remaining epochs. Under tensor parallelism the
        split kernels span processes and the surgery, which edits whole
        tensors on the host, is skipped as the JAX trainer skips it."""
        if self._split:
            logger.warning(
                "auto_rescue: skipped — tensor-sharded params span "
                "processes and host-side surgery cannot gather them; "
                "use tools/slot_rescue.py between runs instead")
            self._rescue_count = 10 ** 9
            return
        m = self.model
        host = {k: v.detach().cpu().numpy()
                for k, v in m.state_dict().items()}
        it = self.train_iterator
        frames = getattr(it, "raw_uint8", None)
        frames = frames if frames is not None else it.X
        bg = surgery.median_background(frames)
        health = surgery.slot_health(host, m.n_objs, m.tmpl_size,
                                     template_init=m.template_init)
        salience = surgery.slot_salience(host, m.n_objs, m.tmpl_size,
                                         m.conv_ch, bg,
                                         template_init=m.template_init)
        slots = surgery.select_dead_slots(health, tmpl_px=m.tmpl_size ** 2,
                                          salience=salience)
        radius = self.rescue_disk_radius or (9.0 if m.img_size >= 64
                                             else 3.0)
        seeds = {}
        if self.rescue_seed_color:
            colors = surgery.object_pixel_colors(frames, bg)
            if colors.shape[0] >= 8 * m.n_objs:
                clusters = surgery.color_clusters(colors, m.n_objs)
                slot_cols = surgery.slot_content_colors(
                    host, m.n_objs, m.tmpl_size, m.conv_ch,
                    template_init=m.template_init)
                taken = [slot_cols[i] for i in range(m.n_objs)
                         if i not in slots]
                seeds = dict(zip(slots, surgery.pick_seed_colors(
                    clusters, taken, len(slots))))
        for s in slots:
            host = surgery.rescue_slot(
                host, s, m.n_objs, m.tmpl_size, m.conv_ch, radius=radius,
                content_rgb=seeds.get(s, (0.5,) * m.conv_ch),
                template_init=m.template_init)
        host = surgery.set_background(host, bg)
        with torch.no_grad():
            for name, t in m.state_dict().items():
                t.copy_(torch.from_numpy(np.asarray(host[name])))
        self._rescue_count += 1
        self._last_rescue_ep = ep
        self._rescue_step = self.step
        logger.info(
            "auto_rescue: epoch %d valid recons %.3f > %.3f — slot "
            "health %s salience %s; reset slot(s) %s to disk priors (r=%.1f), "
            "pinned the median background and froze it (bg_lr_mult=0), "
            "optimizer state re-initialized (rescue %d/%d)%s", ep, recons,
            self.rescue_recons, [int(v) for v in health],
            [round(float(v), 3) for v in salience], slots, radius,
            self._rescue_count, self.max_rescues,
            "; seed colors " + str(
                {s: np.round(c, 3).tolist() for s, c in seeds.items()})
            if seeds else "")
        # The schedule restarts with the optimizer, sized to the remaining
        # epochs: the budget less the discovery arms' epochs and the loop
        # epochs already run.
        self.optimizer = self._make_optimizer(
            epochs=max(1, self._opt_args["epochs"] - self._epochs_consumed
                       - ep), bg_lr_mult=0.0)
        self._opt_step0 = self.step

    # ----- train-time physics identification ---------------------------------
    def _identify_physics(self, batch_size):
        """Train-time physics self-identification (--fit_physics_every): fit
        the cell's parameters by trajectory least squares on the model's own
        encoder positions (ops/identify.py), corrected by the rendered
        appearance offsets and slot-aligned: (k, equil) for the spring cell,
        A = g*m^2 for the gravity cell (installed as log_g, log_m being
        frozen at 0); the bouncing cell has none. A fit is installed when it
        is interior to the search grid and explains the trajectories
        decisively better (error under 0.75x) than the current parameters.
        With --learn_frame_offset the offsets go into frame_offset. The
        first accepted fit after the --aux_on_recons trigger turns the
        alignment losses on."""
        m = self.model
        if m.cell_type not in ("spring_ode_cell", "gravity_ode_cell"):
            return
        _, dt = cells.CELLS[m.cell_type]
        it = self.train_iterator
        encs = []
        with torch.no_grad():
            for _ in range(4):
                bx, _ = it.sample_random_batch(
                    min(batch_size, it.num_examples - 1))
                _, aux = m(torch.from_numpy(bx).to(self.device))
                encs.append(aux["enc_pos"].cpu().numpy())
        enc = np.concatenate(encs)                   # [N, t_in, n_objs*2]
        offsets = self._rendered_offsets()
        enc = identify.align_slots(enc + offsets[None, None], m.n_objs)
        kw = dict(input_steps=m.input_steps, substeps=m.cell_substeps)
        if m.cell_type == "spring_ode_cell":
            k, equil, err = identify.fit_spring_trajectory(enc, dt, **kw)
            cur_err = identify.spring_trajectory_error(
                enc, dt, float(np.exp(m.log_k.item())),
                float(np.exp(m.log_equil.item())), **kw)
            if (identify.on_bounds(k, identify.SPRING_K_BOUNDS)
                    or identify.on_bounds(equil, identify.SPRING_E_BOUNDS)):
                logger.info("fit_physics: rejected (k=%.3f equil=%.3f on "
                            "search bounds — no interior optimum)", k, equil)
                return
            fitted = {"log_k": k, "log_equil": equil}
            found = "k=%.4f equil=%.4f" % (k, equil)
        else:
            A, err = identify.fit_gravity_trajectory(enc, dt, **kw)
            cur_err = identify.gravity_trajectory_error(
                enc, dt, float(np.exp(m.log_g.item())), **kw)
            if identify.on_bounds(A, identify.GRAVITY_A_BOUNDS):
                logger.info("fit_physics: rejected (A=%.3f on search "
                            "bounds — no interior optimum)", A)
                return
            fitted = {"log_g": A}
            found = "A=g*m^2=%.4f" % A
        if err >= 0.75 * cur_err:
            logger.info("fit_physics: rejected (fit err %.3f not "
                        "decisively under current %.3f)", err, cur_err)
            return
        with torch.no_grad():
            for name, value in fitted.items():
                getattr(m, name).fill_(
                    float(np.float32(np.log(max(value, 1e-3)))))
            if m.learn_frame_offset:
                m.frame_offset.copy_(torch.as_tensor(offsets,
                                                     dtype=torch.float32))
        logger.info("fit_physics: %s (median traj err %.3f, was %.3f)",
                    found, err, cur_err)
        if (self.aux_on_recons > 0 and self._aux_triggered
                and self.aux_warmup_steps >= NEVER):
            self.aux_warmup_steps = self.step
            logger.info(
                "fit_physics: first accepted fit — physics-alignment "
                "losses now active (step %d)", self.step)

    def _rendered_offsets(self) -> np.ndarray:
        """Per-slot appearance-centroid offsets in image px (object-major
        x, y, flat [n_objs*2]): the centroid of each object's own rendered
        appearance (composited mask x content luminance) minus the encoder
        position it was rendered at; the median over the frames of the
        first 8 train sequences."""
        m = self.model
        n = min(8, self.train_iterator.num_examples)
        bx = self.train_iterator.X[:n]
        with torch.no_grad():
            _, aux = m(torch.from_numpy(bx).to(self.device),
                       with_extras=True)
        masks = aux["extras"]["transf_masks"].cpu().numpy()    # [F,o+1,H,W]
        conts = aux["extras"]["transf_contents"].cpu().numpy()  # [F,o,H,W,C]
        pos_at = aux["enc_pos"].cpu().numpy().reshape(-1, m.n_objs, 2)
        w = masks[:, :m.n_objs] * conts.mean(axis=-1)           # [F,o,H,W]
        hh, ww = w.shape[-2:]
        xs = np.arange(ww, dtype=np.float64) + 0.5
        ys = np.arange(hh, dtype=np.float64) + 0.5
        tot = w.sum(axis=(2, 3)) + 1e-9
        cx = (w.sum(axis=2) * xs).sum(-1) / tot
        cy = (w.sum(axis=3) * ys).sum(-1) / tot
        per_frame = np.stack([cx, cy], axis=-1) - pos_at        # [F,o,2]
        return np.median(per_frame, axis=0).reshape(-1)
