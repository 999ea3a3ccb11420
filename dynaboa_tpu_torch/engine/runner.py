"""Streaming runner (counterpart of ``dynaboa_tpu/engine/runner.py``): adapt
on every frame of an ordered stream, aggregate MPJPE / PA-MPJPE / PVE and
write the same artifacts (``res.txt``, ``scalars.jsonl``, the npz records
and, with ``save_predictions``, ``result/Pred_*.npz``).

Modes, as in the JAX runner:
- ``window_size=W``: W consecutive frames form one batch that shares one
  bilevel update; the final partial window is padded with its last real
  frame and the pad rows are masked out of every loss and never recorded.
- ``chunk_size=C``: C frames (or windows) go to ``BilevelEngine.run_chunk``
  and their outputs come to the host after the chunk.
- ``checkpoint_every`` / ``resume_from``: bit-exact resume from the
  checkpoint of ``engine.checkpoint``; a final checkpoint is guaranteed.
- ``auto_reset``: a non-finite loss or metric resets params, teacher and
  optimizer to the initial weights (history, step and rng are kept).
- raw-frame items (fused preprocessing) are cropped on the engine's device.
- a box-conditioned model (CLIFF) gets each item's box: its ``bbox``
  (centre and size) in a frame of ``frame_size`` (width, height) pixels;
  the saved camera is then the full-frame translation.
- ``save_overlays`` (``--save_res``): the predicted mesh over the original
  frame in ``image/Pred_<i>.png`` and the mesh in ``mesh/Pred_<i>.obj``, for
  items whose ``imgname`` names an image that exists.

Recording is synchronous: each frame's (or chunk's) outputs reach the host
right after its step, and its time runs from the upload of its first frame
to that point.  The JAX runner's deferred, packed output fetch is not
ported: it was built for a slow host transport.
"""

from __future__ import annotations

import os
import os.path as osp
import time

import numpy as np
import torch

from dynaboa_tpu_torch import constants
from dynaboa_tpu_torch.engine.bilevel import AdaptState, BilevelEngine, Frame
from dynaboa_tpu_torch.engine.checkpoint import AsyncCheckpointer, load_state
from dynaboa_tpu_torch.metrics.writer import ScalarWriter
from dynaboa_tpu_torch.ops.image import fused_crop_resize_normalize
from dynaboa_tpu_torch.tracing import span

_PER_FRAME_KEYS = ("mpjpe", "pampjpe", "pve", "verts", "rotmat", "beta",
                   "cam", "cam_full")
_META_KEYS = ("imgname", "bbox")


def item_meta(item: dict) -> dict:
    """The part of a stream item that the overlay needs after the step."""
    return {k: item[k] for k in _META_KEYS if k in item}


def frame_from_item(item: dict, device, keypoint_source: str = "gt",
                    img_res: int = constants.IMG_RES,
                    boxed: bool = False) -> Frame:
    """Lift a dataset item (no batch dim) into a Frame on ``device``.  Items
    with ``raw_image`` are cropped there to their ``out_res``, by default
    ``img_res``, resized and normalized.  ``boxed``: the Frame carries the
    item's box, ``(cx, cy, b)`` of its ``bbox`` and ``(w, h)`` of its
    ``frame_size``."""
    j2d = item["op_j2d"] if keypoint_source == "openpose" else item["smpl_j2d"]

    def t(a):
        # batch axis added by torch, so its stride is the dense one (numpy's
        # [None] gives stride 0, which some convolution paths treat apart)
        return torch.tensor(np.asarray(a, np.float32), device=device)[None]

    if "raw_image" in item:
        image = fused_crop_resize_normalize(
            torch.as_tensor(item["raw_image"]).to(device),
            torch.as_tensor(item["center"]).to(device),
            torch.as_tensor(item["scale"]).to(device),
            out_res=int(item.get("out_res", img_res)))[None]
    else:
        image = t(item["image"])
    box = None
    if boxed:
        if "bbox" not in item or "frame_size" not in item:
            raise KeyError("a box-conditioned model needs each item's "
                           "'bbox' (cx, cy, b) and 'frame_size' (w, h)")
        box = t(np.concatenate([np.asarray(item["bbox"], np.float32)[:3],
                                np.asarray(item["frame_size"], np.float32)]))
    return Frame(
        image=image, j2d=t(j2d), pose=t(item["pose"]), betas=t(item["betas"]),
        gender=torch.tensor([int(item["gender"])], dtype=torch.int32,
                            device=device),
        mask=torch.ones((1,), dtype=torch.float32, device=device), box=box)


def frame_from_window(items: list[dict], device, keypoint_source: str = "gt",
                      img_res: int = constants.IMG_RES,
                      boxed: bool = False) -> Frame:
    """Stack W consecutive frames into one batched Frame (B = W).  The
    history ring then stores whole windows, so the motion loss pairs row i
    of window t with row i of window t - interval."""
    frames = [frame_from_item(it, device, keypoint_source, img_res, boxed)
              for it in items]
    return Frame(*[None if getattr(frames[0], k) is None
                   else torch.cat([getattr(f, k) for f in frames])
                   for k in Frame._fields])


def split_window_out(out: dict, W: int) -> list[dict]:
    """Split a window step's host outputs into W per-frame records:
    predictions and metrics slice along the batch axis, the per-update
    records ``(max_updates, B)`` along their second axis, and window-level
    quantities (losses, step counts, feature sims) are shared."""
    res = []
    for j in range(W):
        o = {}
        for k, v in out.items():
            if k in _PER_FRAME_KEYS or k.startswith("lower_"):
                o[k] = v[j:j + 1]
            elif k in ("per_step_mpjpe", "per_step_pampjpe", "per_step_pve"):
                o[k] = v[:, j:j + 1]
            else:
                o[k] = v
        res.append(o)
    return res


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_to_host(v) for v in x]
    return x


def reset_weights(state: AdaptState, template: dict) -> None:
    """The divergence remedy: copy the initial weights into the live params
    and teacher and start a new Adam over the same tensors; the state's
    dicts, history ring, step and rng are kept."""
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(template[k])
            state.teacher_params[k].copy_(template[k])
    opt = state.optimizer
    state.optimizer = type(opt)(list(state.params.values()), **opt.defaults)


def _diverged(out: dict) -> bool:
    checks = [out.get("mpjpe", 0.0), out.get("upper", {}).get("loss", 0.0),
              out.get("lower", {}).get("loss", 0.0)]
    return any(not np.isfinite(np.asarray(c)).all() for c in checks)


class StreamRunner:
    def __init__(self, engine: BilevelEngine, exppath: str,
                 save_predictions: bool = False, checkpoint_every: int = 0,
                 log_every: int = 200, profile_dir: str | None = None,
                 save_overlays: bool = False, img_root: str | None = None,
                 faces=None):
        """``profile_dir``: write a ``torch.profiler`` chrome trace of the
        run there (``trace.json``); each frame's phases are spans in it
        (``runner.build_frame``, ``runner.chunk`` around the engine's
        ``engine.step`` spans, ``runner.to_host``, ``runner.record``,
        ``runner.checkpoint``).  ``save_overlays`` renders the predicted
        mesh over the original frame with the native rasterizer and writes
        ``image/Pred_<i>.png`` + ``mesh/Pred_<i>.obj`` (the reference's
        --save_res path, base_adaptor.py:429-443); it needs items that carry
        ``imgname`` (relative to ``img_root``) and ``bbox``, and the SMPL
        ``faces``."""
        self.engine = engine
        self.exppath = exppath
        for d in ("result", "image", "mesh"):
            os.makedirs(osp.join(exppath, d), exist_ok=True)
        self.writer = ScalarWriter(exppath)
        self.save_predictions = save_predictions
        self.checkpoint_every = checkpoint_every
        self.log_every = log_every
        self.profile_dir = profile_dir
        self.save_overlays = save_overlays
        self.img_root = img_root or ""
        self.faces = faces
        self._ckpt = AsyncCheckpointer()
        self.reset_records()

    def reset_records(self):
        self._renderers: dict[tuple[int, int], object] = {}
        self.mpjpe_all: list[float] = []
        self.pampjpe_all: list[float] = []
        self.pve_all: list[float] = []
        self.lower_mpjpe: dict[int, list[float]] = {}
        self.lower_pampjpe: dict[int, list[float]] = {}
        self.kp2d_lower: list[float] = []
        self.kp2d_upper: dict[int, float] = {}
        self.feat_sims: dict[int, list[float]] = {}
        self.step_sims: dict[int, np.ndarray] = {}
        self.step_losses: dict[int, np.ndarray] = {}
        self.step_stats: dict[int, tuple] = {}
        self.optim_step_record: list[int] = []
        self.step_times: list[float] = []
        self.reset_count = 0
        self.ckpt_failures = 0
        self.ckpt_skipped = 0
        self.frames_seen = 0
        self._first_flush_frames = 0
        # frames_seen at the last accepted periodic submit: the run-end
        # checkpoint is skipped when that write already holds the final state
        self._ckpt_submitted_frames = -1

    def reset_state(self, params, batch_size: int = 1,
                    img_res: int | None = None) -> AdaptState:
        """Divergence remedy: a fresh state from ``params``."""
        return self.engine.init_state(params, batch_size=batch_size,
                                      img_res=img_res)

    def run(self, stream, init_state: AdaptState, keypoint_source: str = "gt",
            resume_from: str | None = None, max_frames: int | None = None,
            chunk_size: int = 1, window_size: int = 1,
            auto_reset: bool = False) -> tuple[AdaptState, dict]:
        """Adapt over ``stream``.  ``init_state`` must be built with
        ``batch_size=window_size``; ``state.step`` counts engine steps
        (windows), so a resumed run starts at frame ``step * window_size``.
        ``max_frames`` is the absolute frame index to stop before."""
        reset_template = None
        if auto_reset:
            # the initial weights, taken before any resume: a reset restores
            # the pristine model, not a possibly degraded checkpoint
            reset_template = {k: v.detach().to("cpu", copy=True)
                              for k, v in init_state.params.items()}

        state = init_state
        start = 0
        if resume_from and osp.exists(resume_from):
            state = load_state(resume_from, init_state)
            start = state.step
            print(f"---> resumed at step {start}")

        n_total = len(stream)
        device = self.engine.device
        res = self.engine.img_res
        boxed = self.engine.boxed
        prof = self._start_profile(device)
        # (first index, frame, each real row's item_meta)
        pending: list[tuple[int, Frame, list[dict]]] = []
        chunk_t0 = None

        def add(i0: int, build, metas: list[dict]):
            nonlocal chunk_t0
            if chunk_t0 is None:
                chunk_t0 = time.perf_counter()
            with span("runner.build_frame"):
                frame = build()
            pending.append((i0, frame, metas))

        def flush():
            nonlocal state, chunk_t0
            if not pending:
                return
            with span("runner.chunk"):
                state, outs = self.engine.run_chunk(
                    state, [f for _, f, _ in pending])
            with span("runner.to_host"):
                outs = _to_host(outs)
            n_frames = sum(len(metas) for _, _, metas in pending)
            dt = (time.perf_counter() - chunk_t0) / n_frames
            chunk_t0 = None
            if not self._first_flush_frames:
                self._first_flush_frames = n_frames
            diverged_at = None
            for (i0, _, metas), out in zip(pending, outs):
                rows = ([out] if window_size == 1
                        else split_window_out(out, len(metas)))
                for j, o in enumerate(rows):
                    self.step_times.append(dt)
                    with span("runner.record"):
                        self._record(i0 + j, o, metas[j])
                if reset_template is not None and diverged_at is None \
                        and _diverged(out):
                    diverged_at = i0
            pending.clear()
            if diverged_at is not None:
                self.reset_count += 1
                print(f"---> non-finite adaptation detected at frame "
                      f"{diverged_at}; resetting model/teacher/optimizer "
                      f"(reset #{self.reset_count})")
                reset_weights(state, reset_template)

        try:
            win_items: list[tuple[int, dict]] = []
            for i, item in enumerate(iter(stream)):
                if i < start * window_size:
                    continue
                if max_frames is not None and i >= max_frames:
                    break
                if window_size == 1:
                    add(i, lambda: frame_from_item(item, device,
                                                   keypoint_source, res,
                                                   boxed),
                        [item_meta(item)])
                else:
                    win_items.append((i, item))
                    if len(win_items) == window_size:
                        items = [it for _, it in win_items]
                        add(win_items[0][0], lambda: frame_from_window(
                            items, device, keypoint_source, res, boxed),
                            [item_meta(it) for it in items])
                        win_items = []
                if len(pending) >= chunk_size:
                    flush()
                if self.checkpoint_every and \
                        (i + 1) % self.checkpoint_every == 0:
                    flush()
                    with span("runner.checkpoint"):
                        self._checkpoint(state)
                if (i + 1) % self.log_every == 0 and self.mpjpe_all:
                    print(f"Step:{i}: MPJPE:{np.mean(self.mpjpe_all):.2f}, "
                          f"PAMPJPE:{np.mean(self.pampjpe_all):.2f}, "
                          f"PVE:{np.mean(self.pve_all):.2f}, "
                          f"{1.0 / np.mean(self.step_times[-self.log_every:]):.2f}"
                          f" fps")
            if win_items:
                # final partial window: pad with the last real frame and mask
                # the pad rows out of every loss; only real rows are recorded
                T = len(win_items)
                items = [it for _, it in win_items]

                def padded():
                    fr = frame_from_window(
                        items + [items[-1]] * (window_size - T), device,
                        keypoint_source, res, boxed)
                    mask = torch.zeros((window_size,), dtype=torch.float32,
                                       device=device)
                    mask[:T] = 1.0
                    return fr._replace(mask=mask)

                add(win_items[0][0], padded,
                    [item_meta(it) for it in items])
                print(f"---> final window padded: {T} real + "
                      f"{window_size - T} masked pad frames")
            flush()
            if self.checkpoint_every and self.frames_seen:
                with span("runner.checkpoint"):
                    self._final_checkpoint(state)
        finally:
            try:
                self._ckpt.wait()
            except RuntimeError as e:
                self.ckpt_failures += 1
                print(f"---> WARNING: final {e}; run results are unaffected")
            finally:
                self._ckpt.close()
                self._stop_profile(prof)

        summary = self.finalize(n_total)
        summary["engine_steps"] = state.step
        summary["param_devices"] = sorted({str(p.device)
                                           for p in state.params.values()})
        summary["param_dtypes"] = sorted({str(p.dtype).removeprefix("torch.")
                                          for p in state.params.values()})
        return state, summary

    # -- checkpoints -----------------------------------------------------------

    def _checkpoint(self, state: AdaptState) -> None:
        """Non-blocking periodic checkpoint: an interval whose predecessor
        is still being written is skipped (and counted), and a write
        failure is counted and reported without stopping the run."""
        try:
            if self._ckpt.submit(osp.join(self.exppath, "checkpoint.npz"),
                                 state, block=False):
                self._ckpt_submitted_frames = self.frames_seen
            else:
                self.ckpt_skipped += 1
                print(f"---> checkpoint interval skipped ({self.ckpt_skipped}"
                      f" so far; the previous write is still in flight)")
        except RuntimeError as e:
            self.ckpt_failures += 1
            print(f"---> WARNING: {e}; run continues, the checkpoint is "
                  f"retried at the next interval")

    def _final_checkpoint(self, state: AdaptState) -> None:
        """One blocking checkpoint of the final state, unless the last
        periodic write already holds it and completed cleanly.  A stale
        failure of an earlier write surfaces in the first attempt, so the
        write is retried once."""
        if self._ckpt_submitted_frames == self.frames_seen:
            try:
                self._ckpt.wait()
                return
            except RuntimeError:
                self.ckpt_failures += 1
        for attempt in range(2):
            try:
                self._ckpt.submit(osp.join(self.exppath, "checkpoint.npz"),
                                  state, block=True)
                return
            except RuntimeError as e:
                self.ckpt_failures += 1
                if attempt == 1:
                    print(f"---> WARNING: {e}; run results are unaffected; "
                          f"the final checkpoint was not saved")

    # -- profiling -------------------------------------------------------------

    def _start_profile(self, device):
        if not self.profile_dir:
            return None
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        return prof

    def _stop_profile(self, prof) -> None:
        if prof is None:
            return
        prof.__exit__(None, None, None)
        os.makedirs(self.profile_dir, exist_ok=True)
        prof.export_chrome_trace(osp.join(self.profile_dir, "trace.json"))

    # -- records ---------------------------------------------------------------

    def _record(self, i: int, out: dict, meta: dict):
        scalars = {}
        self.frames_seen += 1
        if "mpjpe" in out:
            m = float(np.mean(out["mpjpe"]))
            pa = float(np.mean(out["pampjpe"]))
            pv = float(np.mean(out["pve"]))
            # non-finite frames reach the scalar log but not the aggregates
            if np.isfinite(m) and np.isfinite(pa) and np.isfinite(pv):
                self.mpjpe_all.append(m)
                self.pampjpe_all.append(pa)
                self.pve_all.append(pv)
            scalars.update({"metrics/mpjpe": m, "metrics/pampjpe": pa,
                            "metrics/pve": pv})
        for k, v in out.get("lower", {}).items():
            scalars[f"ll/{k}"] = float(np.mean(v))
        for k, v in out.get("upper", {}).items():
            if k.startswith("teacher_"):
                scalars[f"teacher/{k[len('teacher_'):]}"] = float(np.mean(v))
            else:
                scalars[f"ul/{k}"] = float(np.mean(v))
        if "s2dloss" in out.get("lower", {}):
            self.kp2d_lower.append(float(np.mean(out["lower"]["s2dloss"])))
        if "s2dloss" in out.get("upper", {}):
            self.kp2d_upper[i] = float(np.mean(out["upper"]["s2dloss"]))
        j = 0
        while f"lower_{j}_mpjpe" in out:
            self.lower_mpjpe.setdefault(j, []).append(
                float(np.mean(out[f"lower_{j}_mpjpe"])))
            self.lower_pampjpe.setdefault(j, []).append(
                float(np.mean(out[f"lower_{j}_pampjpe"])))
            scalars[f"metrics/lower_{j}_mpjpe"] = self.lower_mpjpe[j][-1]
            scalars[f"metrics/lower_{j}_pampjpe"] = self.lower_pampjpe[j][-1]
            j += 1
        if "optim_steps" in out:
            self.optim_step_record.append(int(out["optim_steps"]))
            scalars["dynamic/optim_steps"] = self.optim_step_record[-1]
        if "feat_sim" in out:
            sims = np.asarray(out["feat_sim"])
            self.feat_sims[i] = sims.tolist()
            scalars["feat_sim/cos_sim"] = float(sims.mean())
            gate = self.engine.gate_tap
            scalars[f"feat_sim/tap{gate}"] = float(sims[gate])
        if "per_step_sims" in out:
            nupd = int(out["optim_steps"]) + 1
            self.step_sims[i] = np.asarray(out["per_step_sims"])[:nupd].copy()
            self.step_losses[i] = np.asarray(
                out["per_step_loss"])[:nupd].copy()
            if "per_step_mpjpe" in out:
                self.step_stats[i] = tuple(
                    np.asarray(out[k])[:nupd].mean(-1)
                    for k in ("per_step_mpjpe", "per_step_pampjpe",
                              "per_step_pve"))
        self.writer.write(i, scalars)

        if self.save_predictions:
            # 'cam' is the weak-perspective cam converted to a camera
            # translation (a box-conditioned model's: the full-frame one);
            # the raw crop-space cam rides along as 'cam_crop'
            cam = np.asarray(out["cam"])
            if "cam_full" in out:
                cam_t = np.asarray(out["cam_full"])
            else:
                tz = (2.0 * constants.FOCAL_LENGTH
                      / (self.engine.img_res * cam[:, 0] + 1e-9))
                cam_t = np.stack([cam[:, 1], cam[:, 2], tz], axis=-1)
            np.savez(osp.join(self.exppath, "result", f"Pred_{i}.npz"),
                     verts=out["verts"], cam=cam_t, cam_crop=cam,
                     rotmat=out["rotmat"], beta=out["beta"])

        if self.save_overlays and meta.get("imgname"):
            self._render_overlay(i, out, meta)

    def _render_overlay(self, i: int, out: dict, meta: dict):
        """--save_res: the mesh over the original frame + its OBJ (reference
        base_adaptor.py:429-443, through the native rasterizer).  Frames
        whose image does not exist are skipped."""
        path = meta["imgname"]
        if self.img_root and not osp.isabs(path):
            path = osp.join(self.img_root, path)
        if not osp.exists(path) or self.faces is None:
            return
        import cv2

        from dynaboa_tpu_torch.viz.renderer import (
            Renderer, convert_crop_cam_to_orig_img, save_obj)

        img = cv2.imread(path)
        if img is None:
            return
        verts = np.asarray(out["verts"])[0]
        cam3 = np.asarray(out["cam"])[0]
        h, w = img.shape[:2]
        # one cached renderer per image size (the reference rebuilds its EGL
        # renderer every frame, dynaboa_webcam.py:77)
        rend = self._renderers.get((w, h))
        if rend is None:
            rend = Renderer(resolution=(w, h), faces=self.faces)
            self._renderers[(w, h)] = rend
        orig_cam = convert_crop_cam_to_orig_img(
            np.asarray(cam3, np.float32).reshape(1, 3),
            np.asarray(meta["bbox"], np.float32).reshape(1, 3), w, h)[0]
        over = rend.render(img, verts, orig_cam,
                           color=(205 / 255, 129 / 255, 98 / 255))
        cv2.imwrite(osp.join(self.exppath, "image", f"Pred_{i}.png"), over)
        save_obj(osp.join(self.exppath, "mesh", f"Pred_{i}.obj"), verts,
                 self.faces)

    @staticmethod
    def _padded_trajectories(traj: dict[int, np.ndarray], prefix: str):
        """Ragged per-frame trajectories -> NaN-padded matrix + counts."""
        if not traj:
            return {}
        keys = list(traj.keys())
        counts = np.array([len(traj[i]) for i in keys], np.int32)
        mat = np.full((len(keys), int(counts.max())), np.nan, np.float32)
        for r, i in enumerate(keys):
            mat[r, : counts[r]] = traj[i]
        return {f"{prefix}_steps": np.asarray(keys), f"{prefix}": mat,
                f"{prefix}_counts": counts}

    def finalize(self, n_total: int) -> dict:
        ex = self.exppath
        self.writer.flush()

        def mean(v):
            return float(np.mean(v)) if len(v) else float("nan")

        # the first flush carries the one-off costs (kernel build, cuDNN and
        # allocator warm-up); report steady state when there is more
        first_n = self._first_flush_frames
        steady = (self.step_times[first_n:]
                  if len(self.step_times) > first_n else self.step_times)
        summary = {
            "mpjpe": mean(self.mpjpe_all),
            "pampjpe": mean(self.pampjpe_all),
            "pve": mean(self.pve_all),
            "frames": self.frames_seen,
            "frames_total": n_total,
            "fps": 1.0 / mean(steady) if steady else 0.0,
            "first_frame_s": self.step_times[0] if self.step_times else 0.0,
            "first_flush_frames": first_n,
            "optim_steps": list(self.optim_step_record),
            "reset_count": self.reset_count,
            "checkpoint_failures": self.ckpt_failures,
            "checkpoint_skipped": self.ckpt_skipped,
        }
        print("--- Final ---")
        print(f"MPJPE:{summary['mpjpe']}, PAMPJPE:{summary['pampjpe']}, "
              f"PVE:{summary['pve']}  ({summary['fps']:.2f} adapted fps)")

        np.savez(osp.join(ex, "res.npz"), mpjpe=self.mpjpe_all,
                 pampjpe=self.pampjpe_all, pve=self.pve_all)
        np.savez(osp.join(ex, "lower_res.npz"),
                 mpjpe=np.array([self.lower_mpjpe[k] for k in
                                 sorted(self.lower_mpjpe)], dtype=object),
                 pampjpe=np.array([self.lower_pampjpe[k] for k in
                                   sorted(self.lower_pampjpe)], dtype=object),
                 allow_pickle=True)
        np.savez(osp.join(ex, "lowerlevel_kp2dloss.npz"),
                 kp2dloss=self.kp2d_lower)
        np.savez(osp.join(ex, "upperlevel_kp2dloss.npz"),
                 steps=list(self.kp2d_upper.keys()),
                 kp2dloss=list(self.kp2d_upper.values()))
        if self.feat_sims:
            np.savez(osp.join(ex, "feat_sims.npz"),
                     steps=list(self.feat_sims.keys()),
                     sims=np.asarray(list(self.feat_sims.values())),
                     **self._padded_trajectories(self.step_sims, "per_step"))
        if self.step_stats:
            np.savez(
                osp.join(ex, "steps_statistic_res.npz"),
                **self._padded_trajectories(
                    {i: v[0] for i, v in self.step_stats.items()}, "mpjpe"),
                **self._padded_trajectories(
                    {i: v[1] for i, v in self.step_stats.items()}, "pampjpe"),
                **self._padded_trajectories(
                    {i: v[2] for i, v in self.step_stats.items()}, "pve"),
                **self._padded_trajectories(self.step_losses, "upper_loss"),
            )
        np.savez(osp.join(ex, "optim_step_record.npz"),
                 step=self.optim_step_record)
        with open(osp.join(ex, "res.txt"), "w") as f:
            f.write(f"MPJPE:{summary['mpjpe']}, "
                    f"PAMPJPE:{summary['pampjpe']}, PVE:{summary['pve']}\n")
            for k in sorted(self.lower_mpjpe):
                f.write(f"Lower-level Step:{k} "
                        f"MPJPE:{mean(self.lower_mpjpe[k])}, "
                        f"PAMPJPE:{mean(self.lower_pampjpe[k])}\n")
        return summary

    def close(self):
        self.writer.close()
