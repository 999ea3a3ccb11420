#!/usr/bin/env python
"""Measure the host rasterizer on a real-SMPL-shaped workload (counterpart of
``tools/bench_raster.py``).

The stream app renders the synthetic SMPL stand-in, a noise blob whose
silhouette spans most of the crop, so its render time overstates a real
body.  This tool rasterizes a closed capsule mesh with the real SMPL budget
(6,960 vertices / 13,760 triangles, against SMPL's 6,890 / 13,776) at
human-like screen coverage, through the port's ``viz/renderer.py:Renderer``
(the C++ rasterizer of ``native_lib``), and reports ms per frame.  It
runs on the host alone: no device is involved.

Usage:
  python -m dynaboa_tpu_torch.tools.bench_raster [--w 320] [--h 240]
      [--frames 50]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

# label -> scale of the weak-perspective camera over the body-size one
CAMERAS = (("body-size (75% of frame height)", 1.0),
           ("close-up (silhouette ~2x linear)", 2.0))


def capsule_mesh(rings: int = 87, segs: int = 80,
                 height: float = 1.55, radius: float = 0.16):
    """Closed capsule with ~SMPL vertex/triangle counts, human proportions
    (1.7 units tall incl. caps, 0.32 wide — a standing body silhouette)."""
    vs, fs = [], []
    for i in range(rings):
        t = i / (rings - 1)                      # 0 bottom .. 1 top
        # capsule profile: hemispherical caps, cylindrical trunk
        cap = 0.15
        if t < cap:
            r = radius * np.sin(0.5 * np.pi * t / cap)
            y = -height / 2 - radius * np.cos(0.5 * np.pi * t / cap)
        elif t > 1 - cap:
            u = (1 - t) / cap
            r = radius * np.sin(0.5 * np.pi * u)
            y = height / 2 + radius * np.cos(0.5 * np.pi * u)
        else:
            r = radius
            y = -height / 2 + (t - cap) / (1 - 2 * cap) * height
        for j in range(segs):
            a = 2 * np.pi * j / segs
            vs.append([r * np.cos(a), y, r * np.sin(a)])
    for i in range(rings - 1):
        for j in range(segs):
            a = i * segs + j
            b = i * segs + (j + 1) % segs
            c = (i + 1) * segs + j
            d = (i + 1) * segs + (j + 1) % segs
            fs.append([a, b, c])
            fs.append([b, d, c])
    return (np.asarray(vs, np.float32), np.asarray(fs, np.int32))


def camera(scale: float) -> np.ndarray:
    """(sx, sy, tx, ty): the body fills ~75% of the frame height (a
    standing person in a webcam crop) at scale 1."""
    s = 0.75 / 0.85
    return np.array([s * scale, s * scale, 0.0, 0.0], np.float32)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--w", type=int, default=320)
    ap.add_argument("--h", type=int, default=240)
    ap.add_argument("--frames", type=int, default=50)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from dynaboa_tpu_torch.viz.renderer import Renderer

    verts, faces = capsule_mesh()
    print(f"mesh: {len(verts)} verts / {len(faces)} tris "
          f"(SMPL: 6890 / 13776)")
    img = np.full((args.h, args.w, 3), 128, np.uint8)
    rend = Renderer(resolution=(args.w, args.h), faces=faces,
                    backend="native")
    print(f"rasterizer backend: {rend.backend}")

    rng = np.random.default_rng(0)
    arms = {}
    for label, scale in CAMERAS:
        cam = camera(scale)
        rend.render(img, verts, cam)           # warm
        t0 = time.perf_counter()
        for _ in range(args.frames):
            jitter = verts + rng.normal(scale=0.002, size=(1, 3)).astype(
                np.float32)
            out = rend.render(img, jitter, cam)
        dt = (time.perf_counter() - t0) / args.frames * 1e3
        cover = float((out != img).any(-1).mean())
        print(f"{label}: {dt:.2f} ms/frame ({cover * 100:.0f}% pixel "
              f"coverage at {args.w}x{args.h})", flush=True)
        arms[label] = {"ms_per_frame": dt, "coverage": cover}
    return {"backend": rend.backend, "vertices": len(verts),
            "triangles": len(faces), "resolution": [args.w, args.h],
            "frames": args.frames, "arms": arms}


if __name__ == "__main__":
    main()
