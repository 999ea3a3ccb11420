"""Dynamic bilevel online adaptation, one frame per ``step`` (counterpart of
``dynaboa_tpu/engine/bilevel.py``).

Per frame:

  1. no-grad forward -> the initial feature taps
  2. inner (lower-level) step(s), first-order MAML: the clone is
     ``params - fastlr * grad(L_lower)(params)``
  3. outer (upper-level) Adam updates on the real params.  Update 0 takes
     its gradient at the inner-adapted clone, every later update at the real
     params; each update is followed by the teacher EMA and a post-update
     forward, whose gate-tap cosine against the previous forward gates the
     next update (at most ``1 + optim_steps``).  The gate reads the cosine on
     the host once per update.
  4. SMPL decode of the last forward + MPJPE / PA-MPJPE / PVE
  5. history-ring write

The engine reads of its model (a ``torch.nn.Module``) ``forward(NCHW) ->
(rotmat, shape, cam, taps)``, ``compute_dtype``, the crop it projects at
(``img_res``) and the taps it reads (``retrieval_tap``, the feature that
picks the exemplars; ``gate_tap``, the signal whose cosine gates the
updates): HMR's are 224, 5 and 12 (``models/hmr.py``), HMR 2.0's 256, 1
and 2 (``models/hmr2.py``).

The current frame, the history frame and the retrieved exemplar run as one
batch through the backbone.  Update 0 retrieves with the pre-inner features
(docs/PARITY.md divergence 1), like the JAX engine.  With
``cfg.use_pallas_lbs`` the no-grad SMPL decodes (lower-level record,
per-update records, final prediction) run through the Hopper skinning kernel;
the decodes inside the losses stay on the eager autograd path.

A batch of B rows (the runner's windowed mode, B = W consecutive frames)
shares one bilevel update: every loss term averages over the rows that
``Frame.mask`` marks valid, retrieval keys off row 0, and the gate reads one
cosine per window.  Predictions and metrics stay per row.

``compute_metrics=False`` (unlabeled streams) skips the GT targets and every
metric evaluation: metrics come out as zeros and there are no per-update
records.

The model's ``compute_dtype`` decides the backbone's precision (see
``models/hmr.py``); autocast ends inside the model, so the SMPL decodes,
losses, metrics, gate, Adam and the teacher EMA always run in float32.

The JAX package's two worst-case latency experiments (off by default):
``cfg.fast_extra_updates`` drops the retrieved exemplar and its labeled loss
from the extra updates' batch (update 0 keeps the full loss), and
``cfg.probe_res_factor = f`` runs the post-update probe forward on the image
average-pooled by ``f``, with one full-resolution forward after the loop for
the final prediction.

The state is updated in place: ``step`` returns the same ``AdaptState`` it
was given.

On a card each gradient evaluation (one per level and update) is a CUDA
graph the state captures once per kind and shapes and replays after
(``engine/graphs.py``); the CPU, bfloat16 and each kind's first call in an
engine run eagerly.  ``graph_stats`` counts the evaluations by how they ran.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple

import torch
from torch.func import functional_call

from dynaboa_tpu_torch.config import AdaptConfig
from dynaboa_tpu_torch.engine.graphs import GradGraphs, new_stats
from dynaboa_tpu_torch.engine.retrieval import RetrievalStore, retrieve
from dynaboa_tpu_torch.kernels.lbs import LBSKernelSMPL
from dynaboa_tpu_torch.losses.adaptation import (
    feature_cosine_similarities, frame_loss, keypoint_2d_loss_openpose,
    labeled_loss, motion_loss, teacher_loss)
from dynaboa_tpu_torch.losses.priors import GMMPrior
from dynaboa_tpu_torch.metrics.eval import (GenderedSMPL, evaluate_pred,
                                            gt_targets)
from dynaboa_tpu_torch.models.smpl import smpl_forward
from dynaboa_tpu_torch.ops.camera import project_to_crop
from dynaboa_tpu_torch.tracing import span


class Frame(NamedTuple):
    """One preprocessed frame, batch dim kept; tensors on the engine's
    device."""

    image: torch.Tensor    # (B, H, W, 3) normalized NHWC
    j2d: torch.Tensor      # (B, 49, 3) normalized keypoints + conf
    pose: torch.Tensor     # (B, 72) GT SMPL pose (zeros when unlabeled)
    betas: torch.Tensor    # (B, 10) GT shape
    gender: torch.Tensor   # (B,) int: 0 male / 1 female
    mask: Any = None       # (B,) row validity; None means all valid


@dataclass
class AdaptState:
    """Everything that evolves across the stream."""

    params: dict            # name -> leaf tensor (requires grad)
    teacher_params: dict    # name -> tensor
    optimizer: torch.optim.Adam
    hist_images: torch.Tensor   # (interval, B, H, W, 3) ring buffer
    hist_j2d: torch.Tensor      # (interval, B, 49, 3)
    step: int
    rng: torch.Generator
    # the captured gradient evaluations, freed with the state
    graphs: GradGraphs = field(default_factory=GradGraphs, init=False,
                               repr=False, compare=False)


class History(NamedTuple):
    """What the motion loss reads of the history ring."""

    image: torch.Tensor    # (B, H, W, 3), the slot of frame step - interval
    j2d: torch.Tensor      # (B, 49, 3)
    active: torch.Tensor   # 0-d: 1.0 once step > interval, else 0.0


class _Level(NamedTuple):
    """What one level's gradient evaluation reads: the frame terms, the
    history ring (motion loss), the exemplar rows (labeled loss) and the
    teacher.  The engine builds one per level from the config, once; the
    graph's inputs and the loss both read it.  ``name`` is the graph key's."""

    name: str        # "lower" or "upper"
    frame: bool
    motion: bool
    mixtrain: bool
    teacher: bool


class BilevelEngine:
    def __init__(self, cfg: AdaptConfig, model: torch.nn.Module,
                 prior: GMMPrior, smpls: GenderedSMPL,
                 store: RetrievalStore | None = None,
                 compute_metrics: bool = True):
        if cfg.mixtrain and store is None:
            raise ValueError("mixtrain requires a RetrievalStore")
        self.cfg = cfg
        # the reference adapts in eval mode: dropout off
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.img_res = model.img_res
        self.retrieval_tap = model.retrieval_tap
        self.gate_tap = model.gate_tap
        self.prior = prior
        self.smpls = smpls
        self.store = store
        self.compute_metrics = compute_metrics
        self._record_dynamic = cfg.record_dynamic and compute_metrics
        self._lbs_kernel = (LBSKernelSMPL(smpls.neutral)
                            if cfg.use_pallas_lbs else None)
        # the motion loss's on-switch as a device scalar, so that one graph
        # serves before and after step > interval
        self._motion_switch = (torch.zeros((), device=self.device),
                               torch.ones((), device=self.device))
        # autocast's cast cache cannot be captured: bfloat16 stays eager
        self._graphed = (self.device.type == "cuda"
                         and model.compute_dtype == "float32")
        self._warm: set = set()
        self.graph_stats = new_stats()

        def level(name):
            temporal = getattr(cfg, f"use_temporal_losses_{name}")
            return _Level(name, *map(bool, (
                getattr(cfg, f"use_frame_losses_{name}"),
                temporal and cfg.use_motion,
                getattr(cfg, f"{name}_level_mixtrain"),
                temporal and cfg.use_meanteacher)))

        self._lower, self._upper = level("lower"), level("upper")
        # fast_extra_updates' extra updates leave out the exemplar row
        self._upper_fast = self._upper._replace(mixtrain=False)

    # -- model wrappers ------------------------------------------------------

    def _forward(self, params: dict, image: torch.Tensor):
        """NHWC image -> (rotmat, shape, cam, the model's taps); the NCHW
        view of an NHWC tensor is channels_last, so no copy is made."""
        return functional_call(self.model, params, (image.permute(0, 3, 1, 2),))

    def _decode(self, rotmat, shape, no_grad: bool = False):
        """SMPL decode; ``no_grad=True`` marks call sites outside gradient
        computations, where the skinning kernel (no backward) may serve."""
        lbs_fn = self._lbs_kernel if no_grad else None
        out = smpl_forward(self.smpls.neutral, shape, rotmat, lbs_fn=lbs_fn)
        return out.joints, out.vertices

    @torch.no_grad()
    def predict(self, params, image):
        """Plain inference: image -> dict(rotmat, shape, cam, s3d, verts,
        s2d, feats)."""
        rotmat, shape, cam, feats = self._forward(params, image)
        s3d, verts = self._decode(rotmat, shape, no_grad=True)
        s2d = project_to_crop(cam, s3d, img_res=self.img_res)["normed"]
        return dict(rotmat=rotmat, shape=shape, cam=cam, s3d=s3d,
                    verts=verts, s2d=s2d, feats=feats)

    # -- losses --------------------------------------------------------------

    @torch.no_grad()
    def _teacher_outs(self, teacher_params, frame: Frame):
        t_rotmat, t_shape, t_cam, _ = self._forward(teacher_params, frame.image)
        t_s3d, _ = self._decode(t_rotmat, t_shape)
        t_s2d = project_to_crop(t_cam, t_s3d, img_res=self.img_res)["normed"]
        return (t_rotmat, t_shape, t_s2d, t_s3d)

    def _history(self, state: AdaptState) -> History:
        slot = state.step % self.cfg.interval
        return History(state.hist_images[slot], state.hist_j2d[slot],
                       self._motion_switch[int(state.step
                                               > self.cfg.interval)])

    def _partial_level(self, params, frame: Frame, bank, lv: _Level,
                       hist: History | None):
        """Level ``lv``'s loss without the teacher term: the frame, history
        and exemplar rows in one batched forward.  ``hist`` is read when
        ``lv.motion``, ``bank`` when ``lv.mixtrain``."""
        cfg = self.cfg
        B = frame.image.shape[0]
        imgs = [frame.image]
        if lv.motion:
            imgs.append(hist.image)
        n_ex = 0
        if lv.mixtrain:
            imgs.append(bank.images)
            n_ex = bank.images.shape[0]
        x = torch.cat(imgs, dim=0) if len(imgs) > 1 else imgs[0]

        rotmat, shape, cam, feats_all = self._forward(params, x)
        s3d, _ = self._decode(rotmat, shape)
        s2d = project_to_crop(cam, s3d, img_res=self.img_res)["normed"]

        fr = slice(0, B)
        hi = slice(B, 2 * B)
        ex = slice(x.shape[0] - n_ex, x.shape[0])
        feats = tuple(f[fr] for f in feats_all)

        aux: dict[str, torch.Tensor] = {}
        loss = torch.zeros((), dtype=torch.float32, device=x.device)
        if lv.frame:
            loss, parts = frame_loss(
                self.prior, s2d[fr], rotmat[fr], shape[fr], frame.j2d,
                cfg.s2dloss_weight, cfg.shape_prior_weight,
                cfg.pose_prior_weight, frame.mask,
                kp_loss_fn=(keypoint_2d_loss_openpose
                            if cfg.keypoint_source == "openpose" else None))
            aux.update(parts)
            aux["unlabelloss"] = loss
        if lv.motion:
            # over the 25 OpenPose joints on the stream app's path
            # (reference dynaboa_webcam.py:277), else the 24 GT joints;
            # always computed, masked until step > interval
            ksl = (slice(None, 25) if cfg.keypoint_source == "openpose"
                   else slice(25, None))
            ml = motion_loss(s2d[fr][:, ksl], frame.j2d[:, ksl],
                             s2d[hi][:, ksl], hist.j2d[:, ksl], frame.mask)
            loss = loss + ml * hist.active * cfg.motionloss_weight
            aux["motion_loss"] = ml * hist.active
        if lv.mixtrain:
            ll, lparts = labeled_loss(
                rotmat[ex], shape[ex], s2d[ex], s3d[ex],
                bank.pose, bank.betas, bank.keypoints, bank.pose_3d)
            loss = loss + ll * cfg.labelloss_weight
            aux["labledloss"] = ll
            aux.update(lparts)
        touts = (rotmat[fr], shape[fr], s2d[fr], s3d[fr])
        return loss, touts, feats, aux

    def _level_loss(self, params, frame, bank, lv: _Level, teacher, hist):
        """Full loss at one level: partial terms + teacher distillation;
        ``teacher`` (the teacher's parameters) is read when ``lv.teacher``."""
        loss, touts, feats, aux = self._partial_level(params, frame, bank, lv,
                                                      hist)
        if lv.teacher:
            t_out = self._teacher_outs(teacher, frame)
            tl, tparts = teacher_loss(*touts, *t_out, row_w=frame.mask)
            loss = loss + tl * self.cfg.teacherloss_weight
            aux["teacherloss"] = tl
            aux.update({f"teacher_{k}": v for k, v in tparts.items()})
        return loss, feats, aux

    def _value_and_grad(self, params, frame, bank, lv, teacher, hist):
        loss, feats, aux = self._level_loss(params, frame, bank, lv, teacher,
                                            hist)
        grads = torch.autograd.grad(loss, list(params.values()))
        return (loss.detach(), tuple(f.detach() for f in feats),
                {k: v.detach() for k, v in aux.items()}, grads)

    @staticmethod
    def _grad_key(level: str, own_params: bool, frame: Frame,
                  hist: History | None, bank) -> tuple:
        """What a captured evaluation is specific to: the level, the
        parameter set (the state's own or the inner-adapted clone), and the
        shape and dtype of each input it reads; None marks one it does not
        (no row mask, no history, no exemplar rows)."""
        def spec(x):
            return None if x is None else tuple(
                None if t is None else (tuple(t.shape), t.dtype) for t in x)
        return (level, own_params, spec(frame), spec(hist), spec(bank))

    def _grad(self, state: AdaptState, params: dict, frame: Frame, bank,
              lv: _Level):
        """``_value_and_grad`` of level ``lv`` at ``params`` (the state's
        or the inner-adapted clone) with the state's teacher and history; on
        a card through ``state.graphs``.  The features and gradients it
        returns are to be consumed before the next evaluation."""
        # of the frame the gradient reads the image, keypoints and mask
        inputs = (frame._replace(pose=None, betas=None, gender=None),
                  self._history(state) if lv.motion else None,
                  bank if lv.mixtrain else None)
        teacher = state.teacher_params if lv.teacher else {}

        def evaluate(fr, hist, bk):
            return self._value_and_grad(params, fr, bk, lv, teacher, hist)

        if not self._graphed:
            self.graph_stats["eager"] += 1
            return evaluate(*inputs)
        key = self._grad_key(lv.name, params is state.params, *inputs)
        bound = [*params.values(), *teacher.values()]
        return state.graphs.evaluate(key, self._warm, self.graph_stats,
                                     evaluate, inputs, bound)

    def _retrieve(self, feat5, rng):
        cfg = self.cfg
        if not cfg.mixtrain:
            return None
        if cfg.retrieval:
            return retrieve(self.store, feat5, rng, cfg.sample_num)
        return self.store.bank.take(slice(0, cfg.sample_num))

    # -- optimizer -----------------------------------------------------------

    @staticmethod
    def _outer_update(grads, state: AdaptState):
        for p, g in zip(state.params.values(), grads):
            p.grad = g
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)

    @torch.no_grad()
    def _ema_teacher(self, state: AdaptState):
        """teacher = alpha * teacher + (1 - alpha) * student, in place."""
        a = self.cfg.alpha
        teacher = list(state.teacher_params.values())
        torch._foreach_mul_(teacher, a)
        torch._foreach_add_(teacher, list(state.params.values()), alpha=1.0 - a)

    def _outer_step(self, state: AdaptState, grads):
        """Adam on the state's params, then the teacher EMA."""
        with span("step.optim"):
            self._outer_update(grads, state)
            if self.cfg.use_meanteacher:
                self._ema_teacher(state)

    @torch.no_grad()
    def _metrics(self, verts, targets):
        if targets is None:      # compute_metrics=False
            z = torch.zeros((verts.shape[0],), device=verts.device)
            return {"mpjpe": z, "pampjpe": z, "pve": z}
        return evaluate_pred(self.smpls, verts, targets)

    # -- the per-frame step --------------------------------------------------

    def _cap(self, extra_cap) -> int:
        """Extra updates allowed beyond the mandatory first; the loop's
        bound is ``1 + cfg.optim_steps``, so a larger cap is refused rather
        than silently clamped."""
        if extra_cap is None:
            return self.cfg.optim_steps
        if extra_cap > self.cfg.optim_steps:
            raise ValueError(
                f"extra_cap={extra_cap} exceeds cfg.optim_steps="
                f"{self.cfg.optim_steps}, the update loop's bound; raise "
                "optim_steps to sweep beyond it")
        return int(extra_cap)

    def _probe_image(self, image):
        """The post-update probe's input: the image itself, or with
        ``cfg.probe_res_factor = f`` the image average-pooled by ``f``."""
        pf = self.cfg.probe_res_factor
        if pf == 1:
            return image
        B, H, W, C = image.shape
        if H % pf or W % pf:
            raise ValueError(
                f"probe_res_factor={pf} must divide the image resolution "
                f"{H}x{W} (the probe average-pools by integer factor)")
        return image.reshape(B, H // pf, pf, W // pf, pf, C).mean(dim=(2, 4))

    def run_chunk(self, state: AdaptState, frames: list[Frame],
                  cos_sim_threshold=None, extra_cap=None):
        """Adapt over a chunk of frames (or windows).  Unlike the JAX
        package's ``lax.scan`` there is no fused multi-frame program here:
        it is a loop of ``step`` over the chunk, so a chunked run equals the
        sequential one bit for bit.  Returns ``(state, outputs)``, one
        output dict per frame, still on the device: the caller copies them
        to the host once, after the chunk."""
        outs = []
        for frame in frames:
            state, out = self.step(state, frame, cos_sim_threshold, extra_cap)
            outs.append(out)
        return state, outs

    def step(self, state: AdaptState, frame: Frame, cos_sim_threshold=None,
             extra_cap=None):
        """Adapt on one frame (or one window of B frames) and predict;
        returns ``(state, outputs)`` with ``state`` updated in place.
        ``extra_cap`` bounds the extra updates below ``cfg.optim_steps``.

        Under ``torch.profiler`` the call is the span ``engine.step`` and
        its phases are spans inside it (``tracing.span``): ``step.targets``,
        ``step.init_forward``, ``step.retrieve``, ``step.grad.lower``,
        ``step.inner_update``, ``step.grad.upper``, ``step.optim`` (Adam and
        the teacher EMA), ``step.probe``, ``step.record``,
        ``step.gate_read`` and ``step.decode``; on a card a gradient span
        holds ``step.grad.capture`` or ``step.grad.replay``."""
        with span("engine.step"):
            return self._step(state, frame, cos_sim_threshold, extra_cap)

    def _step(self, state: AdaptState, frame: Frame, cos_sim_threshold,
              extra_cap):
        cfg = self.cfg
        thr = (cfg.cos_sim_threshold if cos_sim_threshold is None
               else float(cos_sim_threshold))
        cap = self._cap(extra_cap)
        outputs: dict[str, Any] = {}

        # prediction-independent GT targets, shared by every evaluation
        eval_targets = None
        if self.compute_metrics:
            with span("step.targets"), torch.no_grad():
                eval_targets = gt_targets(self.smpls, frame.pose, frame.betas,
                                          frame.gender)

        if cfg.use_boa:
            with span("step.init_forward"):
                probe_image = self._probe_image(frame.image)
                with torch.no_grad():
                    rotmat0, shape0, cam0, init_feats = self._forward(
                        state.params, frame.image)

            # inner step(s) on the clone; inner step 0 retrieves off the
            # pre-adaptation features
            learner = state.params
            lower_aux: dict = {}
            rtap, gtap = self.retrieval_tap, self.gate_tap
            feat_r = init_feats[rtap][0]
            for i in range(cfg.inner_step):
                with span("step.retrieve"):
                    bank = self._retrieve(feat_r, state.rng)
                with span("step.grad.lower"):
                    ll, lfeats, lower_aux, g = self._grad(
                        state, learner, frame, bank, self._lower)
                with span("step.inner_update"):
                    # the clone params - fastlr * g, written over g: on a
                    # card g is the lower graph's own output, so the clone
                    # keeps one storage, which upper update 0's graph binds
                    with torch.no_grad():
                        torch._foreach_mul_(g, -cfg.fastlr)
                        torch._foreach_add_(g, list(learner.values()))
                    learner = dict(zip(learner, g))
                    for p in g:
                        p.requires_grad_(True)
                lower_aux["loss"] = ll
                feat_r = lfeats[rtap][0]
                if cfg.record_lowerlevel:
                    with span("step.record"):
                        pred = self.predict(learner, frame.image)
                        m = self._metrics(pred["verts"], eval_targets)
                        outputs[f"lower_{i}_mpjpe"] = m["mpjpe"]
                        outputs[f"lower_{i}_pampjpe"] = m["pampjpe"]
            outputs["lower"] = lower_aux

            max_updates = 1 + (cfg.optim_steps if cfg.dynamic_boa else 0)
            B = frame.image.shape[0]
            dev = frame.image.device
            sims = torch.zeros((max_updates,), device=dev)
            losses = torch.zeros((max_updates,), device=dev)
            recs = (torch.zeros((3, max_updates, B), device=dev)
                    if self._record_dynamic else None)
            # the carried prediction is the probe's: with a reduced-resolution
            # probe, a probe-resolution forward at the pre-update params, so
            # the gate compares taps of one resolution
            if probe_image is frame.image:
                pred_c = (rotmat0, shape0, cam0, init_feats)
            else:
                with span("step.init_forward"), torch.no_grad():
                    pred_c = self._forward(state.params, probe_image)
            upper_aux: dict = {}
            sim = None
            n = 0
            while n < max_updates:
                if n > 0:
                    if n > cap:
                        break
                    # the gate: one host read of the cosine per update
                    with span("step.gate_read"):
                        go = bool((1.0 - sim) > thr)
                    if not go:
                        break
                # fast_extra_updates: the extra updates leave out the
                # exemplar row, so they draw none.  (The JAX engine zero-fills
                # their missing labeled aux keys to give both lax.cond
                # branches one structure; here only update 0's aux is kept.)
                fast = (n > 0 and cfg.fast_extra_updates
                        and cfg.upper_level_mixtrain)
                # update 0 retrieves off the carried pre-inner features
                with span("step.retrieve"):
                    bank = (None if fast
                            else self._retrieve(pred_c[3][rtap][0],
                                                state.rng))
                eval_params = learner if n == 0 else state.params
                with span("step.grad.upper"):
                    ul, _, aux, g = self._grad(
                        state, eval_params, frame, bank,
                        self._upper_fast if fast else self._upper)
                aux["loss"] = ul
                losses[n] = ul
                self._outer_step(state, g)
                with torch.no_grad():
                    # post-update forward: the gate signal, and the final
                    # prediction when the loop stops here
                    with span("step.probe"):
                        post = self._forward(state.params, probe_image)
                        sim = feature_cosine_similarities(
                            (pred_c[3][gtap],), (post[3][gtap],))[0]
                        sims[n] = sim
                    if recs is not None:
                        with span("step.record"):
                            _, verts_p = self._decode(post[0], post[1],
                                                      no_grad=True)
                            m = self._metrics(verts_p, eval_targets)
                            for r, key in enumerate(("mpjpe", "pampjpe",
                                                     "pve")):
                                recs[r, n] = m[key]
                if n == 0:
                    upper_aux = aux
                pred_c = post
                n += 1
            outputs["upper"] = upper_aux
            outputs["optim_steps"] = n - 1
            outputs["feat_sim_final"] = sim
            outputs["per_step_sims"] = sims
            outputs["per_step_loss"] = losses
            if recs is not None:
                outputs["per_step_mpjpe"] = recs[0]
                outputs["per_step_pampjpe"] = recs[1]
                outputs["per_step_pve"] = recs[2]
        else:
            # plain single-level online adaptation
            with span("step.init_forward"), torch.no_grad():
                init_feats0 = self._forward(state.params, frame.image)[3]
            with span("step.retrieve"):
                bank = self._retrieve(init_feats0[self.retrieval_tap][0],
                                      state.rng)
            with span("step.grad.lower"):
                ll, _, lower_aux, g = self._grad(
                    state, state.params, frame, bank, self._lower)
            lower_aux["loss"] = ll
            outputs["lower"] = lower_aux
            self._outer_step(state, g)

        with span("step.decode"), torch.no_grad():
            if cfg.use_boa:
                if probe_image is not frame.image:
                    # the probe's outputs are not the prediction
                    pred_c = self._forward(state.params, frame.image)
                rotmat_f, shape_f, cam_f, feats_f = pred_c
                s3d_f, verts_f = self._decode(rotmat_f, shape_f, no_grad=True)
                pred = dict(rotmat=rotmat_f, shape=shape_f, cam=cam_f,
                            verts=verts_f)
                outputs["feat_sim"] = feature_cosine_similarities(init_feats,
                                                                  feats_f)
            else:
                pred = self.predict(state.params, frame.image)
            outputs.update(self._metrics(pred["verts"], eval_targets))
            outputs["verts"] = pred["verts"]
            outputs["rotmat"] = pred["rotmat"]
            outputs["beta"] = pred["shape"]
            outputs["cam"] = pred["cam"]

            # ring-buffer write: the slot held frame step - interval, which
            # the motion loss above consumed
            slot = state.step % cfg.interval
            state.hist_images[slot] = frame.image
            state.hist_j2d[slot] = frame.j2d
        state.step += 1
        return state, outputs

    # -- state ---------------------------------------------------------------

    def init_state(self, params: dict, batch_size: int = 1,
                   img_res: int | None = None) -> AdaptState:
        """Fresh adaptation state from a name -> tensor parameter dict (e.g.
        ``dict(model.named_parameters())``); student and teacher are copies.
        The history ring holds ``img_res`` square frames, by default the
        model's crop."""
        cfg = self.cfg
        img_res = self.img_res if img_res is None else img_res
        student = {k: v.detach().clone().to(self.device).requires_grad_(True)
                   for k, v in params.items()}
        teacher = {k: v.detach().clone().to(self.device)
                   for k, v in params.items()}
        optimizer = torch.optim.Adam(list(student.values()), lr=cfg.lr,
                                     betas=(cfg.beta1, cfg.beta2), eps=1e-8)
        rng = torch.Generator(device=self.device)
        rng.manual_seed(cfg.seed)
        return AdaptState(
            params=student, teacher_params=teacher, optimizer=optimizer,
            hist_images=torch.zeros(
                (cfg.interval, batch_size, img_res, img_res, 3),
                device=self.device),
            hist_j2d=torch.zeros((cfg.interval, batch_size, 49, 3),
                                 device=self.device),
            step=0, rng=rng)
