#!/usr/bin/env python
"""Live webcam / video streaming adaptation with mesh overlay, on PyTorch
(counterpart of ``dynaboa_tpu/apps/stream.py``).

Capability parity with reference ``dynaboa_webcam.py``: capture -> 2D
BODY_25 keypoints -> keypoint-extent bbox crop (scale factor 1.2, conf
binarized at 0.3) -> dynamic bilevel adaptation with losses over the 25
OpenPose joints -> rendered overlay -> display / video writer.  The 'r' key
(display mode) resets model, teacher and optimizer while keeping the
motion-history ring, frame counter and RNG, like the reference's
``reload()``, which leaves ``self.history`` untouched
(dynaboa_webcam.py:184-195); frames with no detected person pass through
unadapted (dynaboa_webcam.py:404,420-424).

``run`` is the loop without its I/O: BGR uint8 frames in, composited frames
out to a sink, and a summary back (frames, steady frames/s, main-loop ms
per phase, emit ms per record).  ``main`` wraps it with ``cv2``'s capture,
writer and window.

Headless mode pipelines: rendering lags the adaptation by two frames.  As
soon as a frame's step is enqueued, its verts and cam are copied to pinned
host memory with a non-blocking copy and a CUDA event is recorded behind
the copy; a render/write worker thread waits on that event and consumes the
records in order.  So the main thread never waits for a copy, and the
render of frame t - 2 runs while frame t is adapted.  Display mode stays
synchronous with one frame of lag (``cv2.imshow`` and the keys need the
main thread).

Keypoint sources: ``--kp_source openpose`` (the user's OpenPose bindings),
or a precomputed npz (``--kp_file``) so the path runs without them.
``--fused_preprocess 1`` uploads the uint8 frame and crops, resizes and
normalizes it on the engine's device instead of on the host.
``--test_basemodel 1`` renders the frozen base model's mesh beside the
adapted one.

Usage:
  python -m dynaboa_tpu_torch.apps.stream --device cuda --use_pallas_lbs 1 \\
      --capture_mode video --video_file in.mp4 --kp_file kps.npz \\
      --out_video out.mp4
"""

from __future__ import annotations

import collections
import os
import os.path as osp
import queue
import threading
import time

import numpy as np
import torch

from dynaboa_tpu_torch.tracing import span

ADAPTED_COLOR = (205 / 255, 129 / 255, 98 / 255)
BASE_COLOR = (100 / 255, 100 / 255, 200 / 255)
WARMUP_FRAMES = 3
MAIN_PHASES = ("read", "kp", "prep", "submit", "deliver")
EMIT_PARTS = ("fetch", "render", "write")


def build_parser():
    from dynaboa_tpu_torch.apps.benchmark import build_parser as base_parser

    p = base_parser()
    p.set_defaults(expname="stream",
                   # the webcam path runs without retrieval / mixtrain
                   retrieval=0, lower_level_mixtrain=0, upper_level_mixtrain=0,
                   record_lowerlevel=0)
    p.add_argument("--capture_mode", type=str, default="webcam",
                   choices=["webcam", "video"])
    p.add_argument("--camera_id", type=int, default=0)
    p.add_argument("--video_file", type=str, default=None)
    p.add_argument("--kp_source", type=str, default="precomputed",
                   choices=["openpose", "precomputed"])
    p.add_argument("--kp_file", type=str, default=None,
                   help="npz with (N, 25, 3) BODY_25 keypoints")
    p.add_argument("--openpose_models", type=str, default=None)
    p.add_argument("--out_video", type=str, default=None)
    p.add_argument("--display", type=int, default=0, choices=[0, 1])
    p.add_argument("--out_fps", type=float, default=10.0)
    p.add_argument("--test_basemodel", type=int, default=0)
    return p


def keypoints_to_bbox(kp2d: np.ndarray, scale_factor: float = 1.2):
    """bbox from keypoint extremes + conf binarization (reference
    dynaboa_webcam.py dataprocess():197-217).  The extremes -> (center,
    scale) math is the offline internet preprocess's, so the live and
    offline crop conventions cannot diverge."""
    from dynaboa_tpu_torch.data.preprocess.internet import bbox_from_kp

    kp = kp2d[0].copy()
    center, scale = bbox_from_kp(kp, scale_factor)
    center = np.asarray(center, np.float32)
    bbox = np.array([center[0], center[1], scale * 200.0], np.float32)
    kp[:, 2] = kp[:, 2] > 0.3
    return kp, center, float(scale), bbox


def keypoints_to_frame(image_rgb: np.ndarray, kp2d: np.ndarray,
                       scale_factor: float = 1.2, fused: bool = False,
                       device=None):
    """Crop + normalize the frame around the keypoint bbox.  Returns
    ``(image (224, 224, 3), j2d (49, 3), bbox (3,))``: the image is a numpy
    array from the host crop, or with ``fused`` a tensor on ``device``,
    where the uint8 frame is uploaded as it is and cropped, resized and
    normalized (``ops.image.fused_crop_resize_normalize``)."""
    from dynaboa_tpu_torch import constants
    from dynaboa_tpu_torch.data.streams import crop_and_normalize
    from dynaboa_tpu_torch.ops import image as I

    kp, center, scale, bbox = keypoints_to_bbox(kp2d, scale_factor)
    kp_normed = I.normalize_j2d(kp, center, scale)
    # the 49-slot layout: OpenPose half populated, GT half zero
    j2d49 = np.zeros((49, 3), np.float32)
    j2d49[:25] = kp_normed

    if fused:
        raw = torch.from_numpy(np.ascontiguousarray(image_rgb)).to(device)
        img = I.fused_crop_resize_normalize(
            raw, torch.as_tensor(center), torch.as_tensor(scale),
            out_res=constants.IMG_RES)
    else:
        if image_rgb.dtype != np.float32:
            image_rgb = image_rgb.astype(np.float32)
        img = crop_and_normalize(image_rgb, center, scale)
    return img, j2d49, bbox


class HostRecord:
    """A record's tensors on their way to the host.  On the card each one is
    copied into pinned memory with a non-blocking copy, and a CUDA event
    recorded behind the copies marks when they have landed; ``result()``
    waits on that event (from any thread) and returns numpy arrays."""

    def __init__(self, tensors: dict[str, torch.Tensor]):
        self._event = None
        if any(t.is_cuda for t in tensors.values()):
            self._host = {}
            for k, t in tensors.items():
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                self._host[k] = h
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = {k: t.detach() for k, t in tensors.items()}

    def result(self) -> dict[str, np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        return {k: v.numpy() for k, v in self._host.items()}


def fetch_record(out: dict) -> HostRecord:
    """Start the copy of what the render needs: the verts (V, 3) and cam
    (1, 3) of the adapted prediction and, under --test_basemodel, of the
    base model's."""
    tensors = {"verts": out["verts"][0], "cam": out["cam"]}
    if "base" in out:
        tensors["base_verts"] = out["base"]["verts"][0]
        tensors["base_cam"] = out["base"]["cam"]
    return HostRecord(tensors)


class AdaptPipeline:
    """Depth-N-lag adaptation pipeline over an ordered frame stream.

    ``submit`` runs frame t's step and returns the record of frame t - depth
    (or the pass-through record, for frames with no detected person: those
    ride the same queue so the output order is the capture order).
    ``drain`` pops the remaining records one at a time (None when empty).

    ``augment_fn(frame, out) -> out`` attaches extra per-frame outputs (the
    frozen base model's prediction for --test_basemodel); ``fetch_fn(out)``
    then transforms the record at submit time (the stream app starts its
    device-to-host copy there)."""

    def __init__(self, engine, state, depth: int = 1, fetch_fn=None,
                 augment_fn=None):
        self.engine = engine
        self.state = state
        self.depth = depth
        self.fetch_fn = fetch_fn
        self.augment_fn = augment_fn
        self._pending = collections.deque()

    def _push(self, rec):
        self._pending.append(rec)
        if len(self._pending) > self.depth:
            return self._pending.popleft()
        return None

    def submit(self, frame, ctx):
        self.state, out = self.engine.step(self.state, frame)
        if self.augment_fn is not None:
            out = self.augment_fn(frame, out)
        if self.fetch_fn is not None:
            out = self.fetch_fn(out)
        return self._push((out, ctx))

    def submit_passthrough(self, ctx):
        return self._push((None, ctx))

    def drain(self):
        return self._pending.popleft() if self._pending else None

    def sync(self):
        """Block until every in-flight record has completed: the warmup
        barrier, so the first step's one-off costs (kernel build, cuDNN and
        allocator warm-up) land on the warmup frames."""
        for out, _ in self._pending:
            if out is None:
                continue
            if hasattr(out, "result"):
                out.result()
            else:
                out["cam"].cpu()

    def reset(self, engine_params):
        """The divergence remedy (reference reload():184-195): model,
        teacher and optimizer return to the base weights while the
        motion-history ring, frame counter and RNG survive, as the
        reference's ``self.history`` does."""
        from dynaboa_tpu_torch.engine.runner import reset_weights

        reset_weights(self.state, engine_params)


def run(system, frames, provider, sink, fused: bool = False,
        test_basemodel: bool = False, synchronous: bool = False) -> dict:
    """Adapt over ``frames`` (BGR uint8 (H, W, 3), in capture order) and hand
    each composited frame to ``sink`` in the same order.

    ``provider.estimate(frame)`` gives (1, 25, 3) BODY_25 keypoints or None
    (the frame passes through).  Headless (``synchronous=False``): depth-2
    pipeline, and ``sink`` runs on the render worker thread.  With
    ``synchronous=True`` (display mode) the pipeline has depth 1, ``sink``
    runs on the calling thread and may return ``"quit"`` to stop or
    ``"reset"`` to reset the adaptation (``AdaptPipeline.reset``).

    Returns a summary: ``frames`` read, ``adapted`` and ``passthrough``
    counts, ``records`` emitted, ``resets``, ``steady_fps`` over
    ``steady_frames`` after the warmup (None when the stream is too short),
    ``main_ms`` per steady frame by phase (read / kp / prep / submit /
    deliver), ``emit_ms`` per record by part (fetch / render / write),
    ``wait_ms["pipeline"]``, the mean time a steady frame's record waits
    from the end of its own submit until the render takes it up,
    ``graph_stats``, the call's gradient evaluations by how they ran
    (``BilevelEngine.graph_stats``: eager, captured, replayed, and the
    captures' ms), and the devices of the adapted params.  A record's life
    from hand-in to sink is so split into read, kp, prep, submit, the wait,
    fetch, render and write.

    Under ``torch.profiler`` the main loop's phases are the spans
    ``stream.read``, ``stream.kp``, ``stream.prep``, ``stream.submit`` and
    ``stream.deliver``; the render worker's parts have none.
    """
    from dynaboa_tpu_torch.engine.bilevel import Frame
    from dynaboa_tpu_torch.viz.renderer import (Renderer,
                                                convert_crop_cam_to_orig_img)

    if test_basemodel and fused:
        raise ValueError("--test_basemodel requires --fused_preprocess 0 "
                         "(the base predict runs on the host crop)")
    engine = system.engine
    device = system.device
    renderer = Renderer(faces=system.smpls.neutral.faces)
    zeros72 = torch.zeros((1, 72), device=device)
    zeros10 = torch.zeros((1, 10), device=device)
    gender = torch.zeros((1,), dtype=torch.int32, device=device)
    # --test_basemodel (reference dynaboa_webcam.py:330-336, 414-417): the
    # frozen base model predicts the same crop and renders beside the
    # adapted mesh.  system.params stay pristine: init_state copies them.
    base_params = system.params if test_basemodel else None

    E = dict.fromkeys(EMIT_PARTS, 0.0)
    graphs0 = dict(engine.graph_stats)
    counts = {"records": 0, "resets": 0, "waited": 0}
    wait = {"pipeline": 0.0}

    def render_one(frame_bgr, bbox, verts, cam, color):
        if not (np.isfinite(verts).all() and np.isfinite(cam).all()):
            # diverged weights (the reference's remedy is the manual 'r'
            # reset): pass the frame through rather than rasterize NaNs
            return frame_bgr
        h, w = frame_bgr.shape[:2]
        orig_cam = convert_crop_cam_to_orig_img(cam, bbox[None], w, h)[0]
        return renderer.render(frame_bgr, verts, orig_cam, color=color)

    def emit(rec):
        """Render and sink one record; returns what the sink returned."""
        out, ctx = rec
        frame_bgr = ctx["frame_bgr"]
        t0 = time.perf_counter()
        if out is None:
            img = frame_bgr          # nobody detected: pass through
            if base_params is not None:
                # keep the double-width geometry (reference
                # dynaboa_webcam.py:421-424 pads likewise)
                img = np.concatenate([img, frame_bgr], axis=1)
            E["render"] += time.perf_counter() - t0
        else:
            if "submitted" in ctx:
                # a steady frame's record: from the end of its own submit
                # until the render takes it up
                wait["pipeline"] += t0 - ctx["submitted"]
                counts["waited"] += 1
            h = out.result()
            E["fetch"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            img = render_one(frame_bgr, ctx["bbox"], h["verts"], h["cam"],
                             ADAPTED_COLOR)
            if base_params is not None:
                img = np.concatenate([img, render_one(
                    frame_bgr, ctx["bbox"], h["base_verts"], h["base_cam"],
                    BASE_COLOR)], axis=1)
            E["render"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        cmd = sink(img)
        E["write"] += time.perf_counter() - t0
        counts["records"] += 1
        return cmd

    augment_fn = None
    if base_params is not None:
        def augment_fn(frame, out):
            pred = engine.predict(base_params, frame.image)
            return dict(out, base={"verts": pred["verts"],
                                   "cam": pred["cam"]})

    pipeline = AdaptPipeline(engine, engine.init_state(system.params),
                             depth=1 if synchronous else 2,
                             fetch_fn=fetch_record, augment_fn=augment_fn)

    # Headless: the render worker consumes records in order.  A render or
    # sink failure must not kill it silently (the bounded queue would fill
    # and the main loop hang in put()): the first error is latched, the
    # worker keeps draining, and the main loop stops and re-raises it.
    emit_q: queue.Queue | None = None
    emit_err: list[BaseException] = []
    if not synchronous:
        emit_q = queue.Queue(maxsize=8)

        def emit_worker():
            while True:
                rec = emit_q.get()
                if rec is None:
                    return
                if emit_err:
                    continue
                try:
                    emit(rec)
                except BaseException as e:  # noqa: BLE001 (re-raised below)
                    emit_err.append(e)

        emit_thread = threading.Thread(target=emit_worker, daemon=True)
        emit_thread.start()

    def deliver(rec) -> bool:
        if emit_q is not None:
            emit_q.put(rec)
            return True
        cmd = emit(rec)
        if cmd == "reset":
            pipeline.reset(system.params)
            counts["resets"] += 1
            print("the adaptor is reset")
        return cmd != "quit"

    T = dict.fromkeys(MAIN_PHASES, 0.0)
    n_frames = n_adapted = 0
    synced, steady_at, t_steady = False, None, None
    ok_continue = True
    it = iter(frames)
    try:
        while True:
            t0 = time.perf_counter()
            with span("stream.read"):
                frame_bgr = next(it, None)
            if frame_bgr is None:
                break
            t1 = time.perf_counter()
            with span("stream.kp"):
                kp2d = provider.estimate(frame_bgr)
            t2 = time.perf_counter()
            ctx = None
            if kp2d is None:
                t3 = t2
                with span("stream.submit"):
                    done = pipeline.submit_passthrough(
                        {"frame_bgr": frame_bgr})
            else:
                with span("stream.prep"):
                    img, j2d49, bbox = keypoints_to_frame(
                        frame_bgr[:, :, ::-1], kp2d, fused=fused,
                        device=device)
                    image = (img if fused else
                             torch.from_numpy(img).to(device))[None]
                t3 = time.perf_counter()
                ctx = {"frame_bgr": frame_bgr, "bbox": bbox}
                with span("stream.submit"):
                    f = Frame(image=image,
                              j2d=torch.from_numpy(j2d49).to(device)[None],
                              pose=zeros72, betas=zeros10, gender=gender)
                    done = pipeline.submit(f, ctx)
                n_adapted += 1
            t4 = time.perf_counter()
            if ctx is not None and t_steady is not None:
                # the record is still pending here, so no render has it yet
                ctx["submitted"] = t4
            if done is not None:
                with span("stream.deliver"):
                    ok_continue = deliver(done)
            t5 = time.perf_counter()
            if t_steady is not None:
                for k, dt in zip(MAIN_PHASES, (t1 - t0, t2 - t1, t3 - t2,
                                               t4 - t3, t5 - t4)):
                    T[k] += dt
            n_frames += 1
            if not ok_continue or emit_err:
                break
            if not synced and kp2d is not None:
                # warmup barrier, keyed on the first adapted frame so a
                # stream that opens without a person does not land the
                # first step's one-off costs mid-measurement
                pipeline.sync()
                synced = True
                steady_at = n_frames + WARMUP_FRAMES - 1
            if steady_at is not None and n_frames == steady_at:
                t_steady = time.perf_counter()

        while ok_continue and not emit_err and \
                (tail := pipeline.drain()) is not None:
            ok_continue = deliver(tail)
    finally:
        if emit_q is not None:
            emit_q.put(None)
            emit_thread.join()
    if emit_err:
        raise RuntimeError("render/write worker failed") from emit_err[0]

    n_steady = (n_frames - steady_at
                if t_steady is not None and n_frames > steady_at else 0)
    ne = max(counts["records"], 1)
    return {
        "frames": n_frames, "adapted": n_adapted,
        "passthrough": n_frames - n_adapted,
        "records": counts["records"], "resets": counts["resets"],
        "warmup_frames": steady_at, "steady_frames": n_steady,
        "steady_fps": (n_steady / (time.perf_counter() - t_steady)
                       if n_steady else None),
        "main_ms": {k: 1e3 * v / max(n_steady, 1) for k, v in T.items()},
        "emit_ms": {k: 1e3 * v / ne for k, v in E.items()},
        "wait_ms": {k: 1e3 * v / max(counts["waited"], 1)
                    for k, v in wait.items()},
        "graph_stats": {k: v - graphs0[k]
                        for k, v in engine.graph_stats.items()},
        "param_devices": sorted({str(p.device)
                                 for p in pipeline.state.params.values()}),
    }


def _video_frames(cap):
    while True:
        ok, frame = cap.read()
        if not ok or frame is None:
            return
        yield frame


def _camera_frames(source):
    """Each NEW tick of the capture ring once: re-adapting the ring's latest
    frame at full loop speed would desync PrecomputedKeypoints' per-call
    index and write duplicate frames; an ended camera ends the stream."""
    last = 0
    while True:
        tick, frame = source.read()
        if tick != last:
            last = tick
            yield frame
        elif source.ended:
            return
        else:
            time.sleep(0.001)


def build(args):
    """The stream app's system from its parsed arguments: the benchmark
    CLI's configuration with the OpenPose keypoint source, no metrics."""
    from dynaboa_tpu_torch.apps.benchmark import (cfg_from_args,
                                                  refuse_parallel_streams,
                                                  tiny_kwargs)
    from dynaboa_tpu_torch.apps.common import build_system
    from dynaboa_tpu_torch.config import Paths

    refuse_parallel_streams(args, "stream")
    cfg = cfg_from_args(args).replace(keypoint_source="openpose")
    return build_system(cfg, Paths(basemodel=args.model_file), args.device,
                        compute_metrics=False, **tiny_kwargs(args))


def main(argv=None):
    args = build_parser().parse_args(argv)
    from dynaboa_tpu_torch.apps.common import write_settings
    from dynaboa_tpu_torch.viz.capture import (FrameSource, OpenPoseProvider,
                                               PrecomputedKeypoints)

    system = build(args)
    exppath = osp.join(args.expdir, args.expname)
    write_settings(exppath, args)
    import cv2

    if args.kp_source == "openpose":
        provider = OpenPoseProvider(args.openpose_models)
    else:
        if not args.kp_file:
            raise SystemExit("--kp_file required with --kp_source precomputed")
        provider = PrecomputedKeypoints(args.kp_file)

    source = cap = None
    if args.capture_mode == "video":
        if not args.video_file:
            raise SystemExit("--video_file required with "
                             "--capture_mode video")
        cap = cv2.VideoCapture(args.video_file)
        if not cap.isOpened():
            raise SystemExit(f"cannot open video file {args.video_file!r}")
        frames = _video_frames(cap)
    else:
        source = FrameSource(args.camera_id)
        frames = _camera_frames(source)

    writer = None

    def sink(img):
        nonlocal writer
        if args.out_video:
            if writer is None:
                writer = cv2.VideoWriter(
                    args.out_video, cv2.VideoWriter_fourcc(*"mp4v"),
                    args.out_fps, (img.shape[1], img.shape[0]))
            writer.write(img)
        if args.display:
            cv2.imshow("dynaboa_tpu_torch", img)
            key = cv2.waitKey(1) & 0xFF
            if key == ord("q"):
                return "quit"
            if key == ord("r"):
                return "reset"
        return None

    try:
        summary = run(system, frames, provider, sink,
                      fused=bool(args.fused_preprocess),
                      test_basemodel=bool(args.test_basemodel),
                      synchronous=bool(args.display))
    finally:
        if writer is not None:
            writer.release()
        if cap is not None:
            cap.release()
        if source is not None:
            source.stop()
    if summary["steady_fps"] is not None:
        print(f"steady: {summary['steady_fps']:.2f} fps over "
              f"{summary['steady_frames']} frames (excl. "
              f"{summary['warmup_frames']} warmup)")
        print("main-loop ms/frame: " + " ".join(
            f"{k}={v:.1f}" for k, v in summary["main_ms"].items()))
        print("emit ms/record: " + " ".join(
            f"{k}={v:.1f}" for k, v in summary["emit_ms"].items()))
        print(f"pipeline wait ms/record: "
              f"{summary['wait_ms']['pipeline']:.1f}")
        print("gradient evaluations: " + " ".join(
            f"{k}={v:.0f}" for k, v in summary["graph_stats"].items()))
    print(f"processed {summary['frames']} frames")
    return summary["frames"]


if __name__ == "__main__":
    main()
