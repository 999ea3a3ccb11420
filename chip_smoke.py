#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dynaboa_tpu_torch) on one CUDA card.

  python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:
  0. the card: name and power limit from nvidia-smi
  1. build the Hopper skinning kernel from dynaboa_tpu_torch/csrc with nvcc;
     print ptxas' registers, shared memory and spills, and each tile's
     dynamic shared memory and CTAs per SM
  2. the kernel against its plain PyTorch version at full SMPL size
     (V = 6890), N = 1, 3 and 8, identity and random poses, and two launches
     bit-equal; times at N = 1 (the per-frame path) and N = 8 (the window
     batch), hot and cold L2, beside the HBM bound, the share of it reached,
     the one library call that reads the same posedirs stream (the
     pose-blend product alone), an empty kernel and a library call that only
     reads the stream, all under the same timing, and the kernel's grid
     geometries (vertices per CTA x warps), each checked and timed
  3. the main path: the port's 3DPW benchmark CLI, 8 synthetic frames of
     per-frame dynamic bilevel adaptation at full width (ResNet-50-GN,
     224^2, V = 6890) with the skinning kernel on; the kernel's launch count
     over that run must reach the frame count
  4. the same CLI at a tiny size on the card and on the CPU from the same
     seed, every update taken: step counts, losses and metrics must agree
  5. the windowed path at full width: 20 frames in windows of 8 (the last
     one a masked 4-frame tail), a chunk of 2 windows, fused on-device
     preprocessing, a periodic and a final checkpoint; the kernel runs at
     N = 8
  6. resume on the card at full width: 12 frames at W = 4 uninterrupted
     against 8 frames, a checkpoint and a resumed run over the last 4
  7. the internet app at full width on 4 synthetic frames: predictions are
     written, no metric is computed
  8. the stream app at full width: build the native host library (g++,
     csrc/native), then the headless depth-2 pipeline of apps/stream.py
     (OpenPose keypoint loss, no-grad decodes through the kernel, the native
     renderer) over 16 synthetic 480x640 BGR frames with BODY_25 keypoints
     inside the frame, one frame without a person, fused on-device
     preprocessing; then 8 frames with --test_basemodel on the host crop.
     Frames are sunk in memory (no cv2).  Frame count, width, the
     pass-through frame, every adapted frame's overlay, the params' device
     and the kernel's launches are checked; steady frames/s and the
     main-loop and emit ms are printed
  9. --save_res 1 through the benchmark CLI on 4 written 480x640 frames in
     a 3DPW-format archive (needs cv2, which reads and writes the images):
     every frame's prediction, overlay and mesh are written

Phases 3, 5, 6, 7, 8 and 9 each set the kernel's launch count to 0 just before
they drive their path and read it just after; each must launch it.  The
line before the last is a JSON object describing every kernel of the
paths; the last line is {"ok": true, "device": {...}}.  Without a CUDA card
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

N_FRAMES = 8
WINDOW = 8
WINDOW_FRAMES = 20      # 2 full windows + a masked 4-frame tail
RESUME_W = 4
RESUME_FRAMES, RESUME_STOP = 12, 8
KERNEL_ATOL = 1e-5     # fp32, different summation order over 207 + 24 terms
KERNEL_RTOL = 1e-5
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOPS = 67e12          # H100 SXM data sheet, CUDA cores
GEOMETRIES = ((32, 8), (32, 4), (64, 8))   # (vertices per CTA, warps per CTA)
LOSS_RTOL = 2e-3       # the port's CPU/JAX parity tolerance for losses
METRIC_ATOL_MM = 0.05
STREAM_FRAMES, STREAM_BASE_FRAMES = 16, 8
STREAM_H, STREAM_W = 480, 640
STREAM_NOBODY = 5       # the frame index without a person


def phase(name):
    print(f"=== {name}", flush=True)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_cuda(fn, iters: int = 200, flush=None) -> float:
    """Median device milliseconds of ``fn()`` from CUDA events around each
    call.  A ~0.5 ms device sleep before the first event keeps the card busy
    while the host enqueues ``fn``, so the events time the device work and
    not the host's launch overhead.  ``flush()`` (before the sleep) evicts
    the L2 between calls."""
    import torch

    for _ in range(10):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        torch.cuda._sleep(1_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def skin_bound(n: int, V: int):
    """Least time of one skinning call on the card: each input read once,
    each output written once, over the HBM rate, against the operations
    over the fp32 rate.  Returns (ms, 'bytes' or 'operations', bytes)."""
    nbytes = 4 * (207 * 3 * V + 24 * V + n * 2 * 3 * V + n * (207 + 24 * 16))
    flops = n * V * (2 * 207 * 3 + 3 + 24 * 24)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def kernel_phase(torch, dev):
    from dynaboa_tpu_torch.kernels import lbs as klbs
    from dynaboa_tpu_torch.models import smpl as tsmpl
    import numpy as np

    model = tsmpl.synthetic_smpl_model(10, dev)
    sk = klbs.LBSKernelSMPL(model)
    rng = np.random.default_rng(0)

    def inputs(n, identity):
        if identity:
            betas = np.zeros((n, 10), np.float32)
            rot = np.broadcast_to(np.eye(3, dtype=np.float32),
                                  (n, 24, 3, 3)).copy()
        else:
            betas = rng.normal(size=(n, 10)).astype(np.float32)
            A = rng.normal(size=(n * 24, 3, 3))
            Q, R = np.linalg.qr(A)
            Q = Q * np.sign(np.diagonal(R, axis1=-2, axis2=-1))[:, None, :]
            Q[np.linalg.det(Q) < 0, :, 0] *= -1
            rot = Q.reshape(n, 24, 3, 3).astype(np.float32)
        return (torch.as_tensor(betas, device=dev),
                torch.as_tensor(rot, device=dev))

    def plain_args(betas, rot):
        v_shaped, J = tsmpl.shaped_vertices_and_joints(model, betas)
        _, rel = tsmpl._rigid_transform_chain(rot, J, model.parents)
        return (tsmpl.pose_features(rot), sk.posedirs_t,
                v_shaped.contiguous(), sk.weights_t, rel.contiguous())

    max_err = 0.0
    with torch.no_grad():
        for n, identity in ((1, True), (1, False), (3, False), (3, True),
                            (8, False), (8, True)):
            betas, rot = inputs(n, identity)
            before = klbs.skin.launches
            verts, joints = sk(betas, rot)
            if klbs.skin.launches != before + 1:
                raise RuntimeError("the CUDA path did not launch the kernel")
            plain = klbs.skin_plain(*plain_args(betas, rot))
            _, eager_joints = tsmpl.lbs(model, betas, rot)
            torch.cuda.synchronize()
            torch.testing.assert_close(verts, plain, atol=KERNEL_ATOL,
                                       rtol=KERNEL_RTOL)
            if not torch.equal(joints, eager_joints):
                raise RuntimeError("posed joints differ from the eager path")
            if identity:
                torch.testing.assert_close(
                    verts, model.v_template.expand(n, -1, -1),
                    atol=KERNEL_ATOL, rtol=0)
            err = float((verts - plain).abs().max())
            max_err = max(max_err, err)
            print(f"kernel vs plain N={n} identity={identity}: max abs err "
                  f"{err:.3e}", flush=True)
            if not torch.equal(klbs.skin(*plain_args(betas, rot)), verts):
                raise RuntimeError(f"two launches differ at N={n}")

        # times at the per-frame path's shape (N = 1) and the window
        # batch's (N = 8), hot and cold L2
        scrub = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device=dev)

        def flush():
            scrub.zero_()

        V = model.v_template.shape[0]
        times = {}
        for n in (1, WINDOW):
            args = plain_args(*inputs(n, False))
            pf = args[0]
            bound_ms, bound_by, nbytes = skin_bound(n, V)
            for label, fl in (("hot", None), ("cold", flush)):
                # plain, library, kernel, kernel, library, plain: all see the
                # same conditions
                p1 = time_cuda(lambda: klbs.skin_plain(*args), flush=fl)
                l1 = time_cuda(lambda: torch.matmul(pf, model.posedirs),
                               flush=fl)
                k1 = time_cuda(lambda: klbs.skin(*args), flush=fl)
                k2 = time_cuda(lambda: klbs.skin(*args), flush=fl)
                l2 = time_cuda(lambda: torch.matmul(pf, model.posedirs),
                               flush=fl)
                p2 = time_cuda(lambda: klbs.skin_plain(*args), flush=fl)
                t = dict(ms=min(k1, k2), plain_ms=min(p1, p2),
                         library_ms=min(l1, l2), bound_ms=bound_ms,
                         bound_by=bound_by,
                         share_of_bound=bound_ms / min(k1, k2))
                times[n, label] = t
                print(f"lbs_skin N={n} {label} L2: kernel "
                      f"{t['ms'] * 1e3:.2f} us  plain "
                      f"{t['plain_ms'] * 1e3:.2f} us  library (partial: the "
                      f"pose-blend product alone, torch.matmul(pose_feature,"
                      f" posedirs)) {t['library_ms'] * 1e3:.2f} us  bound "
                      f"{bound_ms * 1e3:.2f} us ({nbytes} B over "
                      f"{HBM_BYTES_PER_S / 1e12} TB/s, by {bound_by})  share "
                      f"of bound {t['share_of_bound']:.3f} (device time: "
                      f"median of 200 CUDA-event timings, better of 2 "
                      f"rounds)", flush=True)

        # what the timing itself costs, and what a library call takes only to
        # read the same posedirs stream, under the same method
        tiny = torch.empty(1, device=dev)
        reader = sk.posedirs_t.view(sk.posedirs_t.shape[0], -1)
        floors = {}
        for label, fl in (("hot", None), ("cold", flush)):
            floors[label] = dict(
                launch_floor_ms=min(time_cuda(tiny.zero_, flush=fl)
                                    for _ in range(2)),
                read_ms=min(time_cuda(lambda: reader.sum(1), flush=fl)
                            for _ in range(2)))
            print(f"floors, {label} L2: an empty kernel "
                  f"{floors[label]['launch_floor_ms'] * 1e3:.2f} us; "
                  f"per-tile torch.sum over the {sk.posedirs_t.numel() * 4} "
                  f"B of tile-major posedirs (reads the stream, nothing "
                  f"else) "
                  f"{floors[label]['read_ms'] * 1e3:.2f} us", flush=True)
        for (n, label), t in times.items():
            t.update(floors[label])

        # the kernel's grid geometries, timed in turns in this call
        geometries = []
        for tile, warps in GEOMETRIES:
            gk = klbs.LBSKernelSMPL(model, tile=tile)
            row = dict(tile=tile, warps=warps, ctas=-(-V // tile),
                       smem_bytes=klbs.library().lib.lbs_skin_smem_bytes(tile),
                       ctas_per_sm=klbs.library().lib.lbs_skin_blocks_per_sm(
                           tile, warps, dev.index or 0))
            for n in (1, WINDOW):
                b, r = inputs(n, False)
                a = plain_args(b, r)
                a = (a[0], gk.posedirs_t, a[2], gk.weights_t, a[4])
                err = float((klbs.skin(*a, warps=warps)
                             - klbs.skin_plain(*a)).abs().max())
                if not err <= KERNEL_ATOL:
                    raise RuntimeError(f"geometry {tile}x{warps} N={n}: "
                                       f"max abs err {err}")
                for label, fl in (("hot", None), ("cold", flush)):
                    row[f"ms_n{n}_{label}"] = min(
                        time_cuda(lambda: klbs.skin(*a, warps=warps),
                                  flush=fl) for _ in range(2))
            geometries.append(row)
            print(f"geometry: {row['ctas']} CTAs of {tile} vertices x "
                  f"{warps} warps, {row['smem_bytes']} B dynamic shared "
                  f"memory, {row['ctas_per_sm']} CTAs per SM: N=1 cold "
                  f"{row['ms_n1_cold'] * 1e3:.2f} us hot "
                  f"{row['ms_n1_hot'] * 1e3:.2f} us; N={WINDOW} cold "
                  f"{row[f'ms_n{WINDOW}_cold'] * 1e3:.2f} us hot "
                  f"{row[f'ms_n{WINDOW}_hot'] * 1e3:.2f} us", flush=True)
        torch.cuda.synchronize()
    return max_err, times, geometries


def main_path_phase(torch, tmp):
    from dynaboa_tpu_torch.apps import benchmark
    from dynaboa_tpu_torch.kernels import lbs as klbs

    expdir = os.path.join(tmp, "exps")
    klbs.skin.launches = 0
    t0 = time.perf_counter()
    summary = benchmark.main([
        "--device", "cuda", "--synthetic", str(N_FRAMES),
        "--use_pallas_lbs", "1", "--expdir", expdir, "--expname", "smoke"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = klbs.skin.launches

    run = os.path.join(expdir, "smoke")
    for f in ("res.txt", "scalars.jsonl"):
        if not os.path.exists(os.path.join(run, f)):
            raise RuntimeError(f"the main path wrote no {f}")
    if summary["param_devices"] != ["cuda:0"]:
        raise RuntimeError(f"engine params on {summary['param_devices']}")
    if summary["frames"] != N_FRAMES:
        raise RuntimeError(f"{summary['frames']} frames adapted")
    for k in ("mpjpe", "pampjpe", "pve"):
        if not math.isfinite(summary[k]):
            raise RuntimeError(f"{k} = {summary[k]}")
    if launches < N_FRAMES:
        raise RuntimeError(f"skinning kernel launched {launches} times over "
                           f"{N_FRAMES} frames")
    print(f"main path: {N_FRAMES} frames in {wall:.1f} s (first frame "
          f"{summary['first_frame_s']:.2f} s), steady {summary['fps']:.3f} "
          f"frames/s; per-frame extra steps {summary['optim_steps']}; "
          f"MPJPE {summary['mpjpe']:.2f} PA-MPJPE {summary['pampjpe']:.2f} "
          f"PVE {summary['pve']:.2f}; kernel launches {launches}", flush=True)
    return launches, summary


def cross_device_phase(tmp):
    """The port's CLI at the tiny size on the card and on the CPU from one
    seed, every update taken (thr = -1): the per-frame step counts, losses
    and metrics must agree."""
    import numpy as np

    from dynaboa_tpu_torch.apps import benchmark

    runs = {}
    for dev in ("cpu", "cuda"):
        expdir = os.path.join(tmp, "tiny")
        benchmark.main([
            "--device", dev, "--tiny", "1", "--synthetic", "4",
            "--interval", "2", "--optim_steps", "2",
            "--cos_sim_threshold", "-1", "--retrieval", "0",
            "--use_pallas_lbs", "1", "--expdir", expdir, "--expname", dev])
        run = os.path.join(expdir, dev)
        with open(os.path.join(run, "scalars.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        upper = np.load(os.path.join(run, "steps_statistic_res.npz"))
        runs[dev] = (rows, upper["upper_loss"])
    (cpu_rows, cpu_upper), (gpu_rows, gpu_upper) = runs["cpu"], runs["cuda"]
    if len(cpu_rows) != len(gpu_rows):
        raise RuntimeError(f"{len(cpu_rows)} cpu frames, {len(gpu_rows)} cuda")
    for c, g in zip(cpu_rows, gpu_rows):
        if c["dynamic/optim_steps"] != g["dynamic/optim_steps"]:
            raise RuntimeError(f"frame {c['step']}: step counts differ, cpu "
                               f"{c['dynamic/optim_steps']} cuda "
                               f"{g['dynamic/optim_steps']}")
        for k in ("ll/loss", "ul/loss", "teacher/loss"):
            np.testing.assert_allclose(g[k], c[k], rtol=LOSS_RTOL,
                                       err_msg=f"frame {c['step']} {k}")
        for k in c:
            if k.startswith("metrics/"):
                np.testing.assert_allclose(g[k], c[k], rtol=0,
                                           atol=METRIC_ATOL_MM,
                                           err_msg=f"frame {c['step']} {k}")
    np.testing.assert_allclose(gpu_upper, cpu_upper, rtol=LOSS_RTOL)
    print("tiny CLI run, cuda vs cpu: step counts equal; lower, upper and "
          f"teacher losses within rtol {LOSS_RTOL}; metrics within "
          f"{METRIC_ATOL_MM} mm (last frame's upper losses cpu "
          f"{cpu_upper[-1]} cuda {gpu_upper[-1]})", flush=True)


def check_summary(summary, frames: int, steps: int, metrics: bool = True):
    if summary["param_devices"] != ["cuda:0"]:
        raise RuntimeError(f"engine params on {summary['param_devices']}")
    if summary["frames"] != frames:
        raise RuntimeError(f"{summary['frames']} frames recorded, expected "
                           f"{frames}")
    if summary["engine_steps"] != steps:
        raise RuntimeError(f"{summary['engine_steps']} engine steps, "
                           f"expected {steps}")
    for k in ("mpjpe", "pampjpe", "pve"):
        if metrics and not math.isfinite(summary[k]):
            raise RuntimeError(f"{k} = {summary[k]}")


def windowed_phase(torch, tmp):
    """20 frames, windows of 8, chunks of 2 windows, fused preprocessing
    and periodic checkpoints, at full width with the kernel on."""
    from dynaboa_tpu_torch.apps import benchmark
    from dynaboa_tpu_torch.apps.common import build_system
    from dynaboa_tpu_torch.engine.checkpoint import load_state
    from dynaboa_tpu_torch.kernels import lbs as klbs

    argv = ["--device", "cuda", "--synthetic", str(WINDOW_FRAMES),
            "--window_size", str(WINDOW), "--chunk_size", "2",
            "--fused_preprocess", "1", "--use_pallas_lbs", "1",
            # every 2 windows: a checkpoint flushes the pending windows, so
            # a cadence of one window would never let a chunk of 2 form
            "--checkpoint_every", str(2 * WINDOW),
            "--expdir", os.path.join(tmp, "exps"), "--expname", "window"]
    steps = -(-WINDOW_FRAMES // WINDOW)
    klbs.skin.launches = 0
    t0 = time.perf_counter()
    summary = benchmark.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = klbs.skin.launches
    check_summary(summary, WINDOW_FRAMES, steps)
    if summary["first_flush_frames"] != 2 * WINDOW:
        raise RuntimeError(f"the first flush held {summary['first_flush_frames']}"
                           f" frames, not a chunk of 2 windows")
    if launches < steps:
        raise RuntimeError(f"skinning kernel launched {launches} times over "
                           f"{steps} window steps")
    ckpt = os.path.join(tmp, "exps", "window", "checkpoint.npz")
    if not os.path.exists(ckpt) or os.path.exists(ckpt + ".tmp"):
        raise RuntimeError("no complete checkpoint.npz after the run")
    args = benchmark.build_parser().parse_args(argv)
    system = build_system(benchmark.cfg_from_args(args), None, "cuda")
    state = load_state(ckpt, system.engine.init_state(system.params,
                                                      batch_size=WINDOW))
    if state.step != steps:
        raise RuntimeError(f"checkpoint at step {state.step}, expected {steps}")
    # after the first flush (the chunk of 2 windows) the one steady flush
    # is the padded tail: a full window step of compute for 4 real frames,
    # overlapping the write of the periodic checkpoint taken before it
    tail = WINDOW_FRAMES - 2 * WINDOW
    s_window = tail / summary["fps"]
    print(f"windowed path: {WINDOW_FRAMES} frames, W={WINDOW}, {steps} "
          f"window steps in {wall:.1f} s (first flush, a chunk of 2 windows,"
          f" {summary['first_frame_s'] * 2 * WINDOW:.2f} s); tail "
          f"{s_window:.4f} s per window step = {WINDOW / s_window:.3f} "
          f"aggregate frames/s at W={WINDOW}; per-frame extra steps "
          f"{summary['optim_steps']}; MPJPE {summary['mpjpe']:.2f}; kernel "
          f"launches {launches}; checkpoint loads at step {state.step}",
          flush=True)
    return launches, dict(s_per_window_step=s_window,
                          aggregate_fps=WINDOW / s_window)


def resume_phase(torch, tmp):
    """Uninterrupted 12 frames at W = 4 against 8 frames + checkpoint +
    resume over the last 4, with deterministic cuDNN and algorithms.  The
    final states must be bit-equal, every leaf of them; only where PyTorch
    names an op without a deterministic implementation are the params held
    to the Adam drift bound n_updates * lr instead."""
    import warnings

    from dynaboa_tpu_torch.apps import benchmark
    from dynaboa_tpu_torch.engine.checkpoint import group_diffs
    from dynaboa_tpu_torch.kernels import lbs as klbs

    expdir = os.path.join(tmp, "resume")

    def run(name, *extra):
        return benchmark.main([
            "--device", "cuda", "--synthetic", str(RESUME_FRAMES),
            "--window_size", str(RESUME_W), "--use_pallas_lbs", "1",
            "--checkpoint_every", str(RESUME_W), "--expdir", expdir,
            "--expname", name, *extra])

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    klbs.skin.launches = 0
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            full = run("full")
            half = run("half", "--max_frames", str(RESUME_STOP))
            resumed = run("resumed", "--resume",
                          os.path.join(expdir, "half", "checkpoint.npz"))
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    launches = klbs.skin.launches
    check_summary(full, RESUME_FRAMES, RESUME_FRAMES // RESUME_W)
    check_summary(half, RESUME_STOP, RESUME_STOP // RESUME_W)
    check_summary(resumed, RESUME_FRAMES - RESUME_STOP,
                  RESUME_FRAMES // RESUME_W)
    if launches == 0:
        raise RuntimeError("the resume path never launched the kernel")
    steps_full = full["optim_steps"]
    steps_split = half["optim_steps"] + resumed["optim_steps"]
    if steps_full != steps_split:
        raise RuntimeError(f"step counts differ: uninterrupted {steps_full},"
                           f" resumed {steps_split}")
    nondet = sorted({str(w.message).split(".")[0] for w in caught
                     if "deterministic" in str(w.message)})
    diffs = group_diffs(os.path.join(expdir, "full", "checkpoint.npz"),
                        os.path.join(expdir, "resumed", "checkpoint.npz"))
    for k in ("count", "step", "rng"):
        if diffs[k] != 0.0:
            raise RuntimeError(f"resumed {k} differs from the uninterrupted "
                               f"run's by {diffs[k]}")
    n_updates = sum(n + 1 for n in steps_full[::RESUME_W])
    bound = n_updates * 3e-6       # n_updates * lr, the Adam drift bound
    if not nondet:
        unequal = {k: d for k, d in diffs.items() if d != 0.0}
        if unequal:
            raise RuntimeError(f"resumed state not bit-equal, with no "
                               f"nondeterministic op reported: {unequal}")
    elif diffs["params"] >= bound:
        raise RuntimeError(f"resumed params differ by {diffs['params']:.3e}, "
                           f"beyond the Adam drift bound {bound:.3e}")
    print(f"resume: step counts equal {steps_full}; Adam count, step and rng "
          f"equal; largest difference by part of the state {diffs} (params "
          f"bound n_updates*lr = {bound:.3e} applies only where an op is "
          f"named); kernel launches {launches}; ops without a deterministic "
          f"CUDA implementation: {nondet or 'none reported'}", flush=True)
    return launches, diffs


def internet_phase(torch, tmp):
    import numpy as np

    from dynaboa_tpu_torch.apps import internet
    from dynaboa_tpu_torch.kernels import lbs as klbs

    expdir = os.path.join(tmp, "internet")
    klbs.skin.launches = 0
    summary = internet.main(["--device", "cuda", "--synthetic", "4",
                             "--use_pallas_lbs", "1", "--expdir", expdir])
    launches = klbs.skin.launches
    check_summary(summary, 4, 4, metrics=False)
    if launches == 0:
        raise RuntimeError("the internet path never launched the kernel")
    run = os.path.join(expdir, "internet")
    for i in range(4):
        pred = np.load(os.path.join(run, "result", f"Pred_{i}.npz"))
        shape = pred["verts"].shape
        if len(shape) != 3 or shape[0] != 1 or \
                not np.isfinite(pred["verts"]).all():
            raise RuntimeError(f"Pred_{i}.npz: verts {shape}")
    if summary["mpjpe"] != 0.0 or summary["pve"] != 0.0 or \
            os.path.exists(os.path.join(run, "steps_statistic_res.npz")):
        raise RuntimeError("metrics were computed on the unlabeled stream")
    print(f"internet app: 4 predictions written with finite verts "
          f"{shape}, no metric computed; kernel launches {launches}",
          flush=True)
    return launches


def stream_inputs(n: int, seed: int = 22):
    """n BGR uint8 frames (smooth 8x8 blocks) and their BODY_25 keypoints,
    all inside the frame; frame STREAM_NOBODY has no person."""
    import numpy as np

    rng = np.random.default_rng(seed)
    frames, kps = [], []
    for i in range(n):
        low = rng.integers(0, 256, size=(STREAM_H // 8, STREAM_W // 8, 3))
        frames.append(np.kron(low, np.ones((8, 8, 1))).astype(np.uint8))
        kp = np.concatenate([
            rng.uniform([200, 100], [440, 400], size=(25, 2)),
            rng.uniform(0.4, 1.0, size=(25, 1))], -1).astype(np.float32)
        kps.append(None if i == STREAM_NOBODY else kp)
    return frames, kps


class StreamKeypoints:
    """A keypoint provider over a list: (1, 25, 3) or None per frame."""

    def __init__(self, kps):
        self._kps = list(kps)

    def estimate(self, frame_bgr):
        kp = self._kps.pop(0)
        return None if kp is None else kp[None]


def stream_phase(torch):
    """The stream app's headless pipeline at full width on the card: fused
    preprocessing over 16 frames, then --test_basemodel on the host crop
    over 8.  Returns the kernel launches over the phase and the two runs'
    summaries."""
    import numpy as np

    from dynaboa_tpu_torch import native_lib
    from dynaboa_tpu_torch.apps import stream
    from dynaboa_tpu_torch.kernels import lbs as klbs

    built = native_lib.library()
    print(f"native host library {built.path} built in {built.seconds:.1f} s",
          flush=True)
    launches, summaries = 0, {}
    for label, n, flags in (
            ("fused", STREAM_FRAMES, ["--fused_preprocess", "1"]),
            ("test_basemodel", STREAM_BASE_FRAMES, ["--test_basemodel", "1"])):
        args = stream.build_parser().parse_args([
            "--device", "cuda", "--use_pallas_lbs", "1", *flags])
        system = stream.build(args)
        frames, kps = stream_inputs(n)
        out = []
        klbs.skin.launches = 0
        summary = stream.run(system, iter(frames), StreamKeypoints(kps),
                             out.append, fused=bool(args.fused_preprocess),
                             test_basemodel=bool(args.test_basemodel))
        torch.cuda.synchronize()
        n_launch = klbs.skin.launches
        launches += n_launch
        adapted = n - 1
        if summary["frames"] != n or len(out) != n or \
                summary["adapted"] != adapted:
            raise RuntimeError(f"stream {label}: {summary['frames']} frames, "
                               f"{len(out)} outputs, {summary['adapted']} "
                               f"adapted, expected {n} / {n} / {adapted}")
        if summary["param_devices"] != ["cuda:0"]:
            raise RuntimeError(f"stream {label}: params on "
                               f"{summary['param_devices']}")
        halves = 2 if args.test_basemodel else 1
        for i, (f, o) in enumerate(zip(frames, out)):
            if o.shape != (STREAM_H, halves * STREAM_W, 3) or \
                    o.dtype != np.uint8:
                raise RuntimeError(f"stream {label} frame {i}: output "
                                   f"{o.shape} {o.dtype}")
            for h in range(halves):
                half = o[:, h * STREAM_W:(h + 1) * STREAM_W]
                if i == STREAM_NOBODY and not np.array_equal(half, f):
                    raise RuntimeError(f"stream {label}: the pass-through "
                                       f"frame {i} differs from its input")
                if i != STREAM_NOBODY and np.array_equal(half, f):
                    raise RuntimeError(f"stream {label} frame {i}: no mesh "
                                       f"drawn over the input")
        if n_launch < adapted:
            raise RuntimeError(f"stream {label}: skinning kernel launched "
                               f"{n_launch} times over {adapted} adapted "
                               f"frames")
        summaries[label] = summary
        print(f"stream app, {label}: {n} frames of {STREAM_W}x{STREAM_H} "
              f"({adapted} adapted, 1 passed through), output "
              f"{out[0].shape[1]} wide; steady {summary['steady_fps']:.3f} "
              f"frames/s over {summary['steady_frames']} frames; main-loop "
              f"ms/frame " + " ".join(f"{k}={v:.2f}" for k, v in
                                      summary["main_ms"].items())
              + "; emit ms/record " + " ".join(
                  f"{k}={v:.2f}" for k, v in summary["emit_ms"].items())
              + f"; kernel launches {n_launch}", flush=True)
    return launches, summaries


def save_res_phase(torch, tmp):
    """The benchmark CLI with --save_res 1, at full width, on 4 frames
    written with cv2 and a 3DPW-format archive that names them by absolute
    path; the CLI reads the archive from data/dataset_extras under the
    working directory, so the run is made from ``tmp``."""
    import cv2
    import numpy as np

    from dynaboa_tpu_torch.apps import benchmark
    from dynaboa_tpu_torch.kernels import lbs as klbs

    n = 4
    frames, kps = stream_inputs(n, seed=23)
    root = os.path.join(tmp, "save_res")
    os.makedirs(os.path.join(root, "data", "dataset_extras"))
    names, centers, scales = [], [], []
    for i, (f, kp) in enumerate(zip(frames, kps)):
        names.append(os.path.join(root, f"frame_{i}.png"))
        if not cv2.imwrite(names[-1], f):
            raise RuntimeError(f"cv2 could not write {names[-1]}")
        kp = kps[0] if kp is None else kp
        lo, hi = kp[:, :2].min(0), kp[:, :2].max(0)
        centers.append((lo + hi) / 2)
        scales.append(1.2 * float((hi - lo).max()) / 200.0)
    rng = np.random.default_rng(23)
    j2d = np.concatenate([rng.uniform(200, 440, size=(n, 49, 2)),
                          np.ones((n, 49, 1))], -1).astype(np.float32)
    np.savez(os.path.join(root, "data", "dataset_extras", "3dpw_0_0.npz"),
             imgname=np.array(names), center=np.array(centers, np.float32),
             scale=np.array(scales, np.float32),
             pose=rng.normal(scale=0.2, size=(n, 72)).astype(np.float32),
             shape=rng.normal(scale=0.3, size=(n, 10)).astype(np.float32),
             j2d=j2d, op_j2d=j2d, gender=np.array(["m", "f", "m", "f"]))
    cwd = os.getcwd()
    os.chdir(root)
    klbs.skin.launches = 0
    try:
        summary = benchmark.main([
            "--device", "cuda", "--use_pallas_lbs", "1", "--save_res", "1",
            "--expdir", os.path.join(root, "exps"), "--expname", "run"])
    finally:
        os.chdir(cwd)
    launches = klbs.skin.launches
    check_summary(summary, n, n)
    run = os.path.join(root, "exps", "run")
    for i in range(n):
        over = cv2.imread(os.path.join(run, "image", f"Pred_{i}.png"))
        if over is None or over.shape != frames[i].shape or \
                np.array_equal(over, frames[i]):
            raise RuntimeError(f"overlay {i}: no mesh drawn over the frame")
        for path in (os.path.join(run, "mesh", f"Pred_{i}.obj"),
                     os.path.join(run, "result", f"Pred_{i}.npz")):
            if not os.path.getsize(path):
                raise RuntimeError(f"{path} is empty")
    if launches < n:
        raise RuntimeError(f"--save_res run launched the kernel {launches} "
                           f"times over {n} frames")
    print(f"--save_res: {n} frames of {STREAM_W}x{STREAM_H} through the "
          f"benchmark CLI at full width, each with its prediction, overlay "
          f"and mesh; MPJPE {summary['mpjpe']:.2f}; kernel launches "
          f"{launches}", flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    import dynaboa_tpu_torch  # noqa: F401  (fails outside the repository)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")

    phase("0 card")
    info = card_info()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    phase("1 build")
    from dynaboa_tpu_torch.kernels import lbs as klbs

    built = klbs.library()
    print(f"built {built.path} in {built.seconds:.1f} s", flush=True)
    print("\n".join(line for line in built.ptxas_log.splitlines()
                    if any(w in line for w in ("Compiling", "registers",
                                               "smem", "spill"))),
          flush=True)
    for tile in klbs.TILES:
        print(f"tile {tile}: {built.lib.lbs_skin_smem_bytes(tile)} B dynamic "
              f"shared memory, {built.lib.lbs_skin_blocks_per_sm(tile, klbs.WARPS, 0)}"
              f" CTAs of {klbs.WARPS} warps per SM", flush=True)

    phase("2 kernel vs plain, V=6890")
    max_err, times, geometries = kernel_phase(torch, dev)

    phase(f"3 main path, {N_FRAMES} frames at full width")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches, _ = main_path_phase(torch, tmp)
        phase("4 tiny CLI run, cuda vs cpu")
        cross_device_phase(tmp)
        phase(f"5 windowed path, W={WINDOW}, full width")
        launches_w, _ = windowed_phase(torch, tmp)
        phase(f"6 resume at full width, W={RESUME_W}")
        launches_r, _ = resume_phase(torch, tmp)
        phase("7 internet app at full width")
        launches_i = internet_phase(torch, tmp)
        phase("8 stream app at full width")
        launches_s, _ = stream_phase(torch)
        phase("9 --save_res overlays at full width")
        launches_o = save_res_phase(torch, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    kernels = [{
        "name": "lbs_skin", "route": "cuda",
        "source": "dynaboa_tpu_torch/csrc/lbs_skin.cu",
        "replaces": "dynaboa_tpu/kernels/lbs.py:45",
        "launches": launches, "max_abs_err": max_err,
        **times[1, "cold"],
        **{f"{k}_n8": v for k, v in times[WINDOW, "cold"].items()
           if k not in ("launch_floor_ms", "read_ms")},
        **{f"{k}_hot": v for k, v in times[1, "hot"].items()
           if k not in ("bound_ms", "bound_by")},
        **{f"{k}_n8_hot": v for k, v in times[WINDOW, "hot"].items()
           if k in ("ms", "plain_ms", "library_ms", "share_of_bound")},
        "library_call": "torch.matmul(pose_feature, posedirs) (partial: "
                        "the pose-blend product alone)",
        "launches_by_path": {"per_frame": launches, "windowed": launches_w,
                             "resume": launches_r, "internet": launches_i,
                             "stream": launches_s, "save_res": launches_o},
        "geometries": geometries,
    }]
    print(info)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
