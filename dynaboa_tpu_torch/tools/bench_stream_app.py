#!/usr/bin/env python
"""Measure the stream (webcam/video) app's end-to-end throughput on one CUDA
card (counterpart of ``tools/bench_stream_app.py``).

Drives ``dynaboa_tpu_torch.apps.stream`` in video mode over a synthetic clip
with precomputed BODY_25 keypoints -- the full product path: decode -> bbox
crop -> dynamic bilevel adaptation (OpenPose-joint losses, no retrieval, per
the webcam config) -> the pinned-memory fetch of the verts two frames behind
-> rasterized overlay -> video writer.  Reports the app's own steady
frames/s (its ``steady: X fps`` line, which leaves out its warm-up frames),
or frames over wall time when the clip is too short for a steady window,
and the skinning kernel's launches over the run.

Usage:
  python -m dynaboa_tpu_torch.tools.bench_stream_app [--frames 100]
      [--fused 1] [--device cuda] [--use_pallas_lbs 1]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os.path as osp
import re
import sys
import tempfile
import time

import numpy as np


# A rough standing BODY_25 layout (x, y in a unit person box), so the
# keypoint target is CONSISTENT frame to frame.  Uniformly random keypoints
# per frame give the adaptor an unlearnable target: the model diverges, the
# similarity gate fires every frame, and exploded vertices make the
# rasterizer scan the whole screen per triangle -- benchmarking divergence
# rather than throughput.
_SKELETON = np.array([
    [0.50, 0.08], [0.50, 0.22], [0.38, 0.22], [0.33, 0.38], [0.30, 0.52],
    [0.62, 0.22], [0.67, 0.38], [0.70, 0.52], [0.50, 0.52], [0.42, 0.52],
    [0.42, 0.72], [0.42, 0.92], [0.58, 0.52], [0.58, 0.72], [0.58, 0.92],
    [0.47, 0.06], [0.53, 0.06], [0.44, 0.08], [0.56, 0.08], [0.60, 0.96],
    [0.62, 0.96], [0.57, 0.94], [0.40, 0.96], [0.38, 0.96], [0.43, 0.94],
], np.float32)


def make_clip(path: str, n: int, w: int = 320, h: int = 240, seed: int = 0):
    """Write an ``n``-frame mp4v clip to ``path`` and return its (n, 25, 3)
    BODY_25 keypoints; raises when cv2 cannot write the codec."""
    import cv2

    rng = np.random.default_rng(seed)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
    if not vw.isOpened():
        raise RuntimeError(f"cv2 {cv2.__version__} cannot write {path!r} "
                           "with the mp4v codec")
    # smooth mid-gray frames with a dark person-box blob: pure per-pixel
    # noise gives the backbone garbage features, the adaptor diverges, and
    # the bench ends up measuring divergence handling instead of throughput
    base = np.full((h, w, 3), 128, np.uint8)
    base[30:210, 110:210] = 90
    try:
        for _ in range(n):
            frame = base + rng.integers(-6, 7, size=(h, w, 3)).astype(
                np.int16)
            vw.write(np.clip(frame, 0, 255).astype(np.uint8))
    finally:
        vw.release()
    kps = np.zeros((n, 25, 3), np.float32)
    # person box centered in frame, gentle per-frame jitter (~real tracking)
    box_x, box_y, box_w, box_h = 110.0, 30.0, 100.0, 180.0
    base = np.stack([box_x + _SKELETON[:, 0] * box_w,
                     box_y + _SKELETON[:, 1] * box_h], -1)
    kps[:, :, :2] = base[None] + rng.normal(scale=1.5, size=(n, 25, 2))
    kps[:, :, 2] = 0.9
    return kps


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--fused", type=int, default=1)
    ap.add_argument("--warmup", type=int, default=2,
                    help="frames added at the head of the clip")
    ap.add_argument("--compute_dtype", default="bfloat16")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N or cpu)")
    ap.add_argument("--use_pallas_lbs", type=int, default=1, choices=[0, 1],
                    help="Hopper skinning kernel for the no-grad decodes")
    ap.add_argument("--tiny", type=int, default=0, choices=[0, 1],
                    help="smoke mode: tiny network and body model")
    return ap


def main(argv=None) -> dict:
    """Returns ``fps`` (steady, as the app reports it), whether it came from
    the app's steady line, the frame count, the wall seconds and the
    kernel's launches."""
    args = build_parser().parse_args(argv)
    from dynaboa_tpu_torch.apps import stream
    from dynaboa_tpu_torch.kernels import lbs as klbs

    with tempfile.TemporaryDirectory() as d:
        vid = osp.join(d, "clip.mp4")
        kps = make_clip(vid, args.frames + args.warmup)
        kp_file = osp.join(d, "kps.npz")
        np.savez(kp_file, keypoints=kps)

        argv = ["--expdir", d, "--expname", "bench_stream",
                "--capture_mode", "video", "--video_file", vid,
                "--kp_file", kp_file,
                "--out_video", osp.join(d, "out.mp4"),
                "--device", args.device,
                "--use_pallas_lbs", str(args.use_pallas_lbs),
                "--tiny", str(args.tiny),
                "--fused_preprocess", str(args.fused),
                "--compute_dtype", args.compute_dtype,
                "--record_lowerlevel", "0"]

        # the app reports steady-state fps itself (leaving out its warm-up
        # frames); capture and parse it
        launches0 = klbs.skin.launches
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            n = stream.main(argv)
        dt = time.perf_counter() - t0
        launches = klbs.skin.launches - launches0
    text = buf.getvalue()
    sys.stdout.write(text)
    m = re.search(r"steady: ([\d.]+) fps", text)
    steady = float(m.group(1)) if m else n / dt
    print(f"stream app: {n} frames, wall {dt:.2f}s, steady "
          f"{steady:.2f} fps (fused={args.fused}, {args.compute_dtype}; "
          f"{'the app' if m else 'frames over wall time'}); kernel "
          f"launches {launches}", flush=True)
    return {"fps": steady, "steady_parsed": m is not None, "frames": n,
            "wall_s": dt, "fused": bool(args.fused),
            "compute_dtype": args.compute_dtype,
            "skin_kernel_launches": launches}


if __name__ == "__main__":
    main()
