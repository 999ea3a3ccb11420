#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dynaboa_tpu_torch) on one CUDA card.

  python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:
  0. the card: name and power limit from nvidia-smi
  1. build the Hopper skinning, GroupNorm and convolution kernels from
     dynaboa_tpu_torch/csrc with nvcc; print ptxas' registers, shared memory
     and spills, and each tile's dynamic shared memory and CTAs per SM
  2. the kernel against its plain PyTorch version at full SMPL size
     (V = 6890), N = 1, 3 and 8, identity and random poses, and two launches
     bit-equal; times at N = 1 (the per-frame path) and N = 8 (the window
     batch), hot and cold L2, beside the HBM bound, the share of it reached,
     the one library call that reads the same posedirs stream (the
     pose-blend product alone), an empty kernel and a library call that only
     reads the stream, all under the same timing, and the kernel's grid
     geometries (vertices per CTA x warps), each checked and timed
 2b. the GroupNorm kernel (csrc/group_norm.cu) at the GroupNorm shapes of
     one full-width HMR forward (taken by hooks, with each input's layout),
     N = 1 and 3: its output against nnf.group_norm and the plain version;
     times hot and cold beside the bound (x read once, y written once over
     the HBM rate), the plain version and nnf.group_norm (library_ms), and
     the 53 calls of one forward summed
 2c. the forward-convolution kernel (csrc/conv_fprop.cu) at the 23
     convolution shapes of one full-width HMR forward, N = 1 and 3 (conv1
     on a channels_last view of an NHWC crop): its output and layout
     against nnf.conv2d and the plain version; times hot and cold beside
     the bound (the FLOPs at 67 TFLOP/s, or the bytes at 3.35 TB/s, the
     larger), the plain version and nnf.conv2d (library_ms); the 53 calls
     of one forward summed; and a whole no-grad HMR forward with the kernel
     and with nnf.conv2d in its place, its device time and the host's time
     to enqueue it
  3. the main path: the port's 3DPW benchmark CLI, 8 synthetic frames of
     per-frame dynamic bilevel adaptation at full width (ResNet-50-GN,
     224^2, V = 6890) with the skinning kernel on; the kernel's launch count
     over that run must reach the frame count, the GroupNorm kernel's and
     the convolution kernel's 53 a frame each
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
 10. bf16 at full width: the benchmark CLI with --compute_dtype bfloat16 on
     8 frames (params on the card and float32, finite metrics, launches),
     its steady frames/s beside phase 3's fp32 run; then a trajectory
     qualification in the spirit of the JAX bench, with deterministic
     algorithms (a second fp32 run shows whether one repeats): 32
     frames in bf16 and in fp32 from identical weights and 3 fp32 chaos
     controls (weights scaled by 1 + 1.2e-7, 1 + 2.4e-7, 1 - 1.2e-7): the
     steady-MPJPE relative gap against the controls', the weight drift
     against 4 * n_updates * lr, which must hold, and the L2 distance of
     the bf16 run's weights from the fp32 run's over the fp32 run's own
     distance from the start, which must lie in (0, 1]; whether bf16
     qualifies by the JAX rule is printed.  A failure here is reported
     after the later phases have run, and still fails the script
 11. parallel streams at full width: --parallel_streams 2 through the
     benchmark CLI on 12 frames (res.txt, per-stream frames, launches); then
     run_parallel in-process at S = 1, 2, 4, 8 streams of 4 frames (round
     robin), aggregate frames/s; then one share_weights step of 2 streams
     (params equal across streams, teachers private)
 12. the worst-case experiment flags at full width, threshold -1 and
     optim_steps 7: 3 frames each with fast_extra_updates, with
     probe_res_factor 2 and with neither, the arms in turns frame by frame;
     every frame takes 7 extra updates, outputs are finite, ms per frame
     after the first
 13. offline preparation and fitting at full size, none of which runs the
     skinning kernel (its count over the phase is reported): (a) SMPLify
     at B = 64 with 100 iterations per stage on the V = 6890 body and the
     shipped GMM prior (finite, on the card, the reprojection falls), and a
     V = 256, B = 2, 30-iteration fit on the card and on the CPU within
     num_iters * lr; (b) the dual-head BatchNorm HMRISO at full width with
     seeded weights and running statistics at B = 1 and 8, card against
     CPU, ms per forward; (c) `process_data --dataset 3dpw` in its own
     process (PW3D_ROOT, SMPL_MODEL_DIR, a temp working directory) over a
     synthetic test split in 3DPW's layout: 24 pickles, 37 tracks, about
     35k frames with invalid camera frames mixed in, V = 6890 gendered SMPL
     npz files; 37 archives with their valid frame counts, sequence 0
     against a CPU run, frames/s and the decode's seconds against the
     host's; (d) the retrieval store's features and k = 10 clusters over 256
     synthetic crops through the full-width HMR, 8 crops' tap 5 card
     against CPU, crops/s.  Its numbers are printed as one JSON line
     {"offline": {...}} before the kernels line
 14. full-width parity against the JAX record
     (dynaboa_tpu_torch/tools/fullscale_parity.py against
     dynaboa_tpu_torch/assets/fullscale_jax.npz, recorded by the JAX
     engine on the CPU): three arms of 12 frames at full width with
     deterministic algorithms and TF32 off, the no-grad decodes through the
     skinning kernel: every update taken with retrieval off and on (the
     argmax moving between clusters), and the 3DPW defaults with the
     dynamic gate live.  Step counts, losses, sims, metrics, vertices,
     weights at the recorded coordinates and each leaf's update norm must
     lie within their bounds (the gate arm's counts wherever its margin
     rule applies) on every frame, or within 4x the reference's own
     spread there (JAX from every weight one ulp up or down, recorded with
     it) where that is larger; one line per arm prints each gap beside its
     bound and, where the spread widened it, beside its allowance, and
     {"parity": {...}} is printed before the kernels line
 15. the measuring and endurance drivers of dynaboa_tpu_torch/tools: (a)
     the headline benchmark (bench.py) in-process at full width with
     --full, every arm 3 times at reduced counts (16 frames per streaming
     run and of the bf16 qualification, 4 per worst-case run, realistic-gate
     run and curve point, 16 runner frames, 1 chunk, 4 window steps, 8
     parallel frames): both JSON lines carry every key, finite, and the
     kernel launches; (b) the soak's sequential arm at full width in bf16,
     96 frames, a checkpoint every 24, the kill and resume at 48 past the
     NaN frame's two resets, --bitexact: the resumed state equals the
     straight run's leaf for leaf; (c) the soak's parallel arm on the tiny
     network, 1,000 frames over 8 streams, its RSS bounds held; (d) one
     cold-start child process and a 2-combination sweep of the benchmark
     CLI on the tiny network.  {"drivers": {...}} is printed before the
     kernels line
 16. the attribution and app drivers of dynaboa_tpu_torch/tools at full
     width: (a) profile_update_floor in fp32 and in bf16 at 8 iterations
     per arm, the kernel on: every time, device time, kernel count and
     FLOP count finite and positive (FlopCounterMode counts no FLOP in
     adam_ema), and the decode_metrics arm launches the kernel; (b) the
     worst-case ablation's base, no_teacher, fp32 and no_inner variants at
     4 frames, one run each: every variant asked for ran; (c)
     bench_stream_app over a 24-frame mp4v clip (fused preprocessing): the
     steady frames/s parsed from the app's own line; (d) bench_raster, 20
     frames per camera.  {"attribution": {...}} is printed before the
     kernels line

Phases 3, 5-12 and 14-16 each set the kernel's launch count to 0 just
before they drive their path and read it just after; each must launch it.  The
line before the last is a JSON object describing every kernel of the
paths; the last line is {"ok": true, "device": {...}}, printed only when
every phase passed.  Without a CUDA card
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

N_FRAMES = 8
WINDOW = 8
WINDOW_FRAMES = 20      # 2 full windows + a masked 4-frame tail
RESUME_W = 4
RESUME_FRAMES, RESUME_STOP = 12, 8
KERNEL_ATOL = 1e-5     # fp32, different summation order over 207 + 24 terms
KERNEL_RTOL = 1e-5
GN_TOL = 1e-6          # GroupNorm: fp32 sums in another order, a few ulp
CONV_TOL = 1e-5        # convolution: fp32 sums of up to 4,608 products in
                       # another order, ~sqrt(terms) ulp of the output's scale
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOPS = 67e12          # H100 SXM data sheet, CUDA cores
GEOMETRIES = ((32, 8), (32, 4), (64, 8))   # (vertices per CTA, warps per CTA)
LOSS_RTOL = 2e-3       # the port's CPU/JAX parity tolerance for losses
METRIC_ATOL_MM = 0.05
STREAM_FRAMES, STREAM_BASE_FRAMES = 16, 8
STREAM_H, STREAM_W = 480, 640
STREAM_NOBODY = 5       # the frame index without a person
QUAL_FRAMES = 32
CHAOS_EPS = (1.2e-7, 2.4e-7, -1.2e-7)
BF16_WEIGHT_GAP = 1.0   # |bf16 - fp32| weights over |fp32 - start|, at most
PAR_FRAMES = 12
PAR_PER_STREAM = 4
EXP_FRAMES = 3


T0 = time.perf_counter()


def phase(name):
    print(f"=== {name} (at {time.perf_counter() - T0:.1f} s)", flush=True)


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


def group_norm_shapes(torch, dev):
    """The (C, H, W) of each of the 53 GroupNorm calls of one full-width HMR
    forward on ``dev``, in order, with whether its input is contiguous,
    from a forward of an NHWC image viewed as NCHW, as the engine feeds
    it."""
    from dynaboa_tpu_torch.models.hmr import HMR, GroupNorm32

    model = HMR().to(dev)
    calls = []

    def hook(mod, args):
        x = args[0]
        calls.append((tuple(x.shape[1:]), x.is_contiguous()))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, GroupNorm32)]
    with torch.no_grad():
        model(torch.zeros((1, 224, 224, 3), device=dev).permute(0, 3, 1, 2))
    for h in handles:
        h.remove()
    return calls


def group_norm_phase(torch, dev):
    """The GroupNorm kernel at the main path's shapes (N = 1 and 3) against
    ATen's GroupNorm and the plain version: the gaps, then times hot and
    cold beside the bound (x read once, y written once), the plain version
    and ``nnf.group_norm`` (library_ms)."""
    import torch.nn.functional as nnf

    from dynaboa_tpu_torch.kernels import group_norm as kgn

    calls = group_norm_shapes(torch, dev)
    if len(calls) != 53:
        raise RuntimeError(f"{len(calls)} GroupNorm calls in a forward")
    count = {}
    for chw, _ in calls:
        count[chw] = count.get(chw, 0) + 1
    print(f"GroupNorm inputs of one forward: {len(count)} shapes, "
          f"{sum(not c for _, c in calls)} of 53 not contiguous; ATen on a "
          f"channels_last input returns strides "
          f"{nnf.group_norm(torch.zeros((1, 64, 8, 8), device=dev).to(memory_format=torch.channels_last), 4).stride()}",
          flush=True)
    scrub = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device=dev)

    def flush():
        scrub.zero_()

    g = torch.Generator(device=dev).manual_seed(0)
    rows, worst = [], 0.0
    with torch.no_grad():
        for n in (1, 3):
            for chw in count:
                x = torch.randn((n, *chw), generator=g, device=dev) * 2 + 0.5
                w = 1 + 0.5 * torch.randn((chw[0],), generator=g, device=dev)
                b = 0.5 * torch.randn((chw[0],), generator=g, device=dev)
                y = kgn.group_norm(x, 4, w, b)
                ref = nnf.group_norm(x, 4, w, b)
                plain = kgn.group_norm_plain(x, 4, w, b)[0]
                gap = float((y - ref).abs().max() / ref.abs().max())
                gap_p = float((y - plain).abs().max() / plain.abs().max())
                if not max(gap, gap_p) <= GN_TOL:
                    raise RuntimeError(f"group_norm N={n} {chw}: gap {gap} "
                                       f"to ATen, {gap_p} to plain")
                worst = max(worst, gap, gap_p)
                nbytes = 8 * x.numel()
                row = dict(n=n, chw=list(chw), calls=count[chw],
                           plan=list(kgn.plan(n, chw[0], 4,
                                              chw[1] * chw[2])),
                           bytes=nbytes,
                           bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
                for label, fl in (("hot", None), ("cold", flush)):
                    p1 = time_cuda(lambda: kgn.group_norm_plain(x, 4, w, b),
                                   iters=100, flush=fl)
                    l1 = time_cuda(lambda: nnf.group_norm(x, 4, w, b),
                                   iters=100, flush=fl)
                    k1 = time_cuda(lambda: kgn.group_norm(x, 4, w, b),
                                   iters=100, flush=fl)
                    k2 = time_cuda(lambda: kgn.group_norm(x, 4, w, b),
                                   iters=100, flush=fl)
                    l2 = time_cuda(lambda: nnf.group_norm(x, 4, w, b),
                                   iters=100, flush=fl)
                    p2 = time_cuda(lambda: kgn.group_norm_plain(x, 4, w, b),
                                   iters=100, flush=fl)
                    sfx = "" if label == "cold" else "_hot"
                    row.update({f"ms{sfx}": min(k1, k2),
                                f"plain_ms{sfx}": min(p1, p2),
                                f"library_ms{sfx}": min(l1, l2)})
                rows.append(row)
                print(f"group_norm N={n} C,H,W={chw} x{count[chw]}: plan "
                      f"{row['plan']} cold {row['ms'] * 1e3:.2f} us hot "
                      f"{row['ms_hot'] * 1e3:.2f} us; plain "
                      f"{row['plain_ms'] * 1e3:.2f} / "
                      f"{row['plain_ms_hot'] * 1e3:.2f}; nnf.group_norm "
                      f"{row['library_ms'] * 1e3:.2f} / "
                      f"{row['library_ms_hot'] * 1e3:.2f}; bound "
                      f"{row['bound_ms'] * 1e3:.2f} us ({nbytes} B); "
                      f"gaps {gap:.2e} / {gap_p:.2e}", flush=True)
    totals = {}
    for n in (1, 3):
        mine = [r for r in rows if r["n"] == n]
        for key in ("ms", "ms_hot", "plain_ms", "library_ms",
                    "library_ms_hot", "bound_ms"):
            totals[f"{key}_forward_n{n}"] = sum(r[key] * r["calls"]
                                                for r in mine)
        print(f"group_norm, the 53 calls of one forward at N={n}: kernel "
              f"cold {totals[f'ms_forward_n{n}'] * 1e3:.1f} us hot "
              f"{totals[f'ms_hot_forward_n{n}'] * 1e3:.1f} us; "
              f"nnf.group_norm cold "
              f"{totals[f'library_ms_forward_n{n}'] * 1e3:.1f} us hot "
              f"{totals[f'library_ms_hot_forward_n{n}'] * 1e3:.1f} us; bound "
              f"{totals[f'bound_ms_forward_n{n}'] * 1e3:.1f} us (device "
              f"time: median of 100 CUDA-event timings, better of 2 rounds)",
              flush=True)
    torch.cuda.synchronize()
    return worst, rows, totals


def conv_shapes(torch, dev):
    """The ((C, H, W), K, kernel, stride, padding) of each of the 53
    convolutions of one full-width HMR forward on ``dev``, in order, with
    whether its input is contiguous, from a forward of an NHWC image viewed
    as NCHW, as the engine feeds it."""
    from dynaboa_tpu_torch.models.hmr import HMR, Conv2d32

    model = HMR().to(dev)
    calls = []

    def hook(mod, args):
        x = args[0]
        calls.append(((tuple(x.shape[1:]), mod.out_channels,
                       mod.kernel_size[0], mod.stride[0], mod.padding[0]),
                      x.is_contiguous()))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, Conv2d32)]
    with torch.no_grad():
        model(torch.zeros((1, 224, 224, 3), device=dev).permute(0, 3, 1, 2))
    for h in handles:
        h.remove()
    return calls


def forward_ms(torch, fn, iters: int = 20) -> float:
    """Median device milliseconds of ``fn()``, a whole forward, from CUDA
    events around each call, behind a ~30 ms device sleep: the forward's
    hundreds of launches are queued before the first of them runs, so the
    events time the device and not the host's dispatch."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda._sleep(50_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def enqueue_ms(torch, fn, iters: int = 20) -> float:
    """Median host milliseconds to enqueue ``fn()`` on an idle card (a
    whole forward's launches fit the launch queue, so the host never
    waits on the device inside the timing)."""
    fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def conv_phase(torch, dev):
    """The forward-convolution kernel at the main path's shapes (N = 1 and
    3; conv1 on a channels_last view of an NHWC crop, as the engine feeds
    it) against ATen's convolution and the plain version: the gaps, then
    times hot and cold beside the bound (the FLOPs at the fp32 rate, or
    the input, weight and output bytes at the HBM rate, the larger), the
    plain version and ``nnf.conv2d`` (library_ms); the 53 calls of one
    forward summed; and a whole no-grad HMR forward with the kernel and
    with ATen's convolution in its place, on the device and on the host."""
    import torch.nn.functional as nnf

    from dynaboa_tpu_torch.kernels import conv as kc
    from dynaboa_tpu_torch.models import hmr as mhmr

    calls = conv_shapes(torch, dev)
    if len(calls) != 53:
        raise RuntimeError(f"{len(calls)} convolutions in a forward")
    count = {}
    for shape, _ in calls:
        count[shape] = count.get(shape, 0) + 1
    print(f"convolutions of one forward: {len(count)} shapes, "
          f"{sum(not c for _, c in calls)} of 53 inputs not contiguous",
          flush=True)
    scrub = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device=dev)

    def flush():
        scrub.zero_()

    g = torch.Generator(device=dev).manual_seed(0)
    rows, worst = [], 0.0
    with torch.no_grad():
        for n in (1, 3):
            for shape in count:
                (C, H, W), K, k, s, p = shape
                if C == 3:      # conv1: a channels_last view of NHWC
                    x = torch.randn((n, H, W, C), generator=g,
                                    device=dev).permute(0, 3, 1, 2)
                else:
                    x = torch.randn((n, C, H, W), generator=g, device=dev)
                w = torch.randn((K, C, k, k), generator=g, device=dev) * (
                    2.0 / (k * k * K)) ** 0.5
                st, pd = (s, s), (p, p)
                y = kc.conv2d(x, w, None, st, pd)
                ref = nnf.conv2d(x, w, None, s, p)
                plain = kc.conv2d_plain(x, w, st, pd)
                gap = float((y - ref).abs().max() / ref.abs().max())
                gap_p = float((y - plain).abs().max() / plain.abs().max())
                if not max(gap, gap_p) <= CONV_TOL or \
                        y.stride() != ref.stride():
                    raise RuntimeError(f"conv N={n} {shape}: gap {gap} to "
                                       f"ATen, {gap_p} to plain, strides "
                                       f"{y.stride()} against "
                                       f"{ref.stride()}")
                worst = max(worst, gap, gap_p)
                P = kc.out_size(H, k, s, p)
                flops = 2 * K * C * k * k * n * P * P
                nbytes = 4 * (x.numel() + w.numel() + y.numel())
                t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
                pl = kc.plan(K, n * P * P, C * k * k, k)
                row = dict(n=n, shape=[list(shape[0]), *shape[1:]],
                           calls=count[shape], flops=flops, bytes=nbytes,
                           plan=dict(bm=pl.bm, bn=pl.bn, split=pl.split,
                                     ctas=pl.ctas),
                           bound_ms=max(t_ops, t_bytes) * 1e3,
                           bound_by="operations" if t_ops >= t_bytes
                           else "bytes")
                for label, fl in (("hot", None), ("cold", flush)):
                    times = {"ms": [], "plain_ms": [], "library_ms": []}
                    for key in ("plain_ms", "library_ms", "ms", "ms",
                                "library_ms", "plain_ms"):
                        fn = {"ms": lambda: kc.conv2d(x, w, None, st, pd),
                              "plain_ms": lambda: kc.conv2d_plain(x, w, st,
                                                                  pd),
                              "library_ms": lambda: nnf.conv2d(x, w, None, s,
                                                               p)}[key]
                        times[key].append(time_cuda(fn, iters=100, flush=fl))
                    sfx = "" if label == "cold" else "_hot"
                    row.update({f"{k2}{sfx}": min(v)
                                for k2, v in times.items()})
                row["share_of_bound_hot"] = row["bound_ms"] / row["ms_hot"]
                rows.append(row)
                print(f"conv N={n} {shape} x{count[shape]}: plan "
                      f"{pl.bm}x{pl.bn} split {pl.split} ({pl.ctas} CTAs) "
                      f"cold {row['ms'] * 1e3:.2f} us hot "
                      f"{row['ms_hot'] * 1e3:.2f} us; plain "
                      f"{row['plain_ms'] * 1e3:.2f} / "
                      f"{row['plain_ms_hot'] * 1e3:.2f}; nnf.conv2d "
                      f"{row['library_ms'] * 1e3:.2f} / "
                      f"{row['library_ms_hot'] * 1e3:.2f}; bound "
                      f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}, "
                      f"{flops} FLOP, {nbytes} B), "
                      f"{100 * row['share_of_bound_hot']:.1f} % of it hot; "
                      f"gaps {gap:.2e} / {gap_p:.2e}", flush=True)
    totals = {}
    for n in (1, 3):
        mine = [r for r in rows if r["n"] == n]
        for key in ("ms", "ms_hot", "plain_ms", "plain_ms_hot", "library_ms",
                    "library_ms_hot", "bound_ms"):
            totals[f"{key}_forward_n{n}"] = sum(r[key] * r["calls"]
                                                for r in mine)
        print(f"conv, the 53 calls of one forward at N={n}: kernel cold "
              f"{totals[f'ms_forward_n{n}'] * 1e3:.1f} us hot "
              f"{totals[f'ms_hot_forward_n{n}'] * 1e3:.1f} us; nnf.conv2d "
              f"cold {totals[f'library_ms_forward_n{n}'] * 1e3:.1f} us hot "
              f"{totals[f'library_ms_hot_forward_n{n}'] * 1e3:.1f} us; bound "
              f"{totals[f'bound_ms_forward_n{n}'] * 1e3:.1f} us (device "
              f"time: median of 100 CUDA-event timings, better of 2 rounds)",
              flush=True)
    # a whole no-grad forward with the kernel, then with ATen's convolution:
    # its device time, and the host's time to enqueue it (the eager
    # forwards of the step wait on the latter)
    model = mhmr.HMR().to(dev).eval()
    for n in (1, 3):
        x = torch.randn((n, 224, 224, 3), generator=g,
                        device=dev).permute(0, 3, 1, 2)
        with torch.no_grad():
            fwd, host = {}, {}
            for label in ("kernel", "aten", "aten", "kernel"):
                if label == "aten":
                    mhmr.conv2d = lambda x, w, b, s, p, d, gr: nnf.conv2d(
                        x, w, b, s, p, d, gr)
                try:
                    fwd.setdefault(label, []).append(
                        forward_ms(torch, lambda: model(x)))
                    host.setdefault(label, []).append(
                        enqueue_ms(torch, lambda: model(x)))
                finally:
                    mhmr.conv2d = kc.conv2d
        for key, val in (("hmr_forward_ms", fwd["kernel"]),
                         ("hmr_forward_library_ms", fwd["aten"]),
                         ("hmr_forward_host_ms", host["kernel"]),
                         ("hmr_forward_host_library_ms", host["aten"])):
            totals[f"{key}_n{n}"] = min(val)
        print(f"HMR no-grad forward at N={n}: {min(fwd['kernel']):.3f} ms "
              f"of device with the kernel, {min(fwd['aten']):.3f} ms with "
              f"nnf.conv2d; {min(host['kernel']):.3f} / "
              f"{min(host['aten']):.3f} ms of host to enqueue it",
              flush=True)
    torch.cuda.synchronize()
    return worst, rows, totals


def main_path_phase(torch, tmp):
    from dynaboa_tpu_torch.apps import benchmark
    from dynaboa_tpu_torch.kernels import lbs as klbs

    from dynaboa_tpu_torch.kernels import conv as kc
    from dynaboa_tpu_torch.kernels import group_norm as kgn

    expdir = os.path.join(tmp, "exps")
    klbs.skin.launches = 0
    kgn.group_norm.launches = 0
    kc.conv2d.launches = 0
    t0 = time.perf_counter()
    summary = benchmark.main([
        "--device", "cuda", "--synthetic", str(N_FRAMES),
        "--use_pallas_lbs", "1", "--expdir", expdir, "--expname", "smoke"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = klbs.skin.launches
    gn_launches = kgn.group_norm.launches
    conv_launches = kc.conv2d.launches

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
    if gn_launches < 53 * N_FRAMES:
        raise RuntimeError(f"GroupNorm kernel launched {gn_launches} times "
                           f"over {N_FRAMES} frames")
    if conv_launches < 53 * N_FRAMES:
        raise RuntimeError(f"convolution kernel launched {conv_launches} "
                           f"times over {N_FRAMES} frames")
    print(f"main path: {N_FRAMES} frames in {wall:.1f} s (first frame "
          f"{summary['first_frame_s']:.2f} s), steady {summary['fps']:.3f} "
          f"frames/s; per-frame extra steps {summary['optim_steps']}; "
          f"MPJPE {summary['mpjpe']:.2f} PA-MPJPE {summary['pampjpe']:.2f} "
          f"PVE {summary['pve']:.2f}; kernel launches {launches}; "
          f"GroupNorm kernel launches {gn_launches}, convolution kernel "
          f"launches {conv_launches} (eager and captured calls)", flush=True)
    summary["group_norm_launches"] = gn_launches
    summary["conv_launches"] = conv_launches
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


def bf16_phase(torch, dev, tmp, fp32_summary):
    """The benchmark CLI in bf16 at full width, then the trajectory
    qualification against fp32."""
    import numpy as np

    from dynaboa_tpu_torch.apps import benchmark
    from dynaboa_tpu_torch.apps.common import build_system
    from dynaboa_tpu_torch.config import AdaptConfig
    from dynaboa_tpu_torch.data.streams import SyntheticStream
    from dynaboa_tpu_torch.engine.runner import frame_from_item
    from dynaboa_tpu_torch.kernels import lbs as klbs

    klbs.skin.launches = 0
    summary = benchmark.main([
        "--device", dev.type, "--synthetic", str(N_FRAMES),
        "--compute_dtype", "bfloat16", "--use_pallas_lbs", "1",
        "--expdir", os.path.join(tmp, "exps"), "--expname", "bf16"])
    torch.cuda.synchronize()
    launches = klbs.skin.launches
    check_summary(summary, N_FRAMES, N_FRAMES)
    if summary["param_dtypes"] != ["float32"]:
        raise RuntimeError(f"bf16 run params are {summary['param_dtypes']}")
    if launches < N_FRAMES:
        raise RuntimeError(f"bf16 run launched the kernel {launches} times "
                           f"over {N_FRAMES} frames")
    print(f"bf16 CLI: {N_FRAMES} frames, steady {summary['fps']:.3f} frames/s"
          f" against fp32 {fp32_summary['fps']:.3f} (phase 3, this call); "
          f"per-frame extra steps {summary['optim_steps']}; MPJPE "
          f"{summary['mpjpe']:.2f}; params {summary['param_dtypes']} on "
          f"{summary['param_devices']}; kernel launches {launches}",
          flush=True)

    cfg = AdaptConfig(record_lowerlevel=False, use_pallas_lbs=True)
    sys16 = build_system(cfg.replace(compute_dtype="bfloat16"), None, dev)
    sys32 = build_system(cfg, None, dev)
    for k, v in sys32.params.items():
        if not torch.equal(v, sys16.params[k]):
            raise RuntimeError(f"bf16 and fp32 weights differ at {k}")
    frames = [frame_from_item(it, dev)
              for it in SyntheticStream(QUAL_FRAMES, seed=22)]

    def trajectory(system, params):
        eng = system.engine
        st = eng.init_state(params)
        mpjpe, updates = [], 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for fr in frames:
            st, out = eng.step(st, fr)
            mpjpe.append(float(out["mpjpe"].mean()))
            updates += int(out["optim_steps"]) + 1
        fps = len(frames) / (time.perf_counter() - t0)
        return np.asarray(mpjpe), updates, st, fps

    # without deterministic algorithms two fp32 runs of the same frames
    # differ, and over a short horizon that difference is the size of the
    # gap under test
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        m16, upd16, st16, fps16 = trajectory(sys16, sys16.params)
        m32, upd32, st32, fps32 = trajectory(sys32, sys32.params)
        m32_again = trajectory(sys32, sys32.params)[0]
        controls_run = [trajectory(sys32, {k: v * (1.0 + eps)
                                           for k, v in sys32.params.items()})
                        for eps in CHAOS_EPS]
        controls_m = [r[0] for r in controls_run]
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    repeat_mm = float(np.abs(m32 - m32_again).max())
    tail = QUAL_FRAMES // 2
    steady32 = max(abs(m32[tail:].mean()), 1e-9)
    controls = []
    for mc in controls_m:
        if not np.isfinite(mc).all():
            raise RuntimeError("non-finite MPJPE in a chaos control")
        controls.append(float(abs(mc[tail:].mean() - m32[tail:].mean())
                              / steady32))
    if not (np.isfinite(m16).all() and np.isfinite(m32).all()):
        raise RuntimeError("non-finite MPJPE in the bf16 trajectory")
    rel = float(abs(m16[tail:].mean() - m32[tail:].mean()) / steady32)
    n_updates = 0.5 * (upd16 + upd32)
    bound = 4.0 * n_updates * cfg.lr
    drift = max(float((st16.params[k] - st32.params[k]).detach().abs().max())
                for k in st32.params)

    def tree_dist(a, b):
        return math.sqrt(sum(float(((a[k] - b[k]).detach().double() ** 2)
                                   .sum()) for k in a))

    # the bf16 run's weights against the fp32 run's, as a share of how far
    # the fp32 run moved them: an update of unrelated direction and the same
    # size reads about 1.4, an fp32 engine 0
    moved = tree_dist(st32.params, sys32.params)
    gap = tree_dist(st16.params, st32.params) / moved
    control_gaps = [tree_dist(r[2].params, st32.params) / moved
                    for r in controls_run]
    print(f"bf16 weights: |bf16 - fp32| = {gap:.4f} of |fp32 - start| "
          f"({moved:.4e}); chaos controls "
          f"{[round(g, 4) for g in control_gaps]}", flush=True)
    if not math.isfinite(drift) or drift > bound:
        raise RuntimeError(f"bf16 weight drift {drift:.3e} beyond the Adam "
                           f"bound 4*n_updates*lr = {bound:.3e}")
    if not 0.0 < gap <= BF16_WEIGHT_GAP:
        raise RuntimeError(f"bf16 weights {gap:.4f} of the fp32 update away "
                           f"from fp32's, outside (0, {BF16_WEIGHT_GAP}]")
    qualifies = rel <= max(0.02, 2.0 * max(controls))
    print(f"bf16 trajectory, {QUAL_FRAMES} frames from identical weights: "
          f"steady MPJPE (last {QUAL_FRAMES - tail}) bf16 "
          f"{m16[tail:].mean():.4f} fp32 {m32[tail:].mean():.4f}, rel gap "
          f"{rel:.5f}; chaos controls {[round(c, 5) for c in controls]}; "
          f"weight drift {drift:.3e} = {drift / bound:.3f} of the bound "
          f"{bound:.3e} (n_updates {n_updates:g}); qualifies by the JAX rule "
          f"(rel <= max(0.02, 2 * worst control)): {qualifies}; a second fp32 "
          f"run differs from the first by at most {repeat_mm} mm per frame; "
          f"frames/s in this loop "
          f"(deterministic algorithms) bf16 {fps16:.3f} fp32 {fps32:.3f}",
          flush=True)
    return launches, dict(fps16=summary["fps"], fps32=fp32_summary["fps"],
                          traj_fps16=fps16, traj_fps32=fps32, rel=rel,
                          controls=controls, drift=drift, bound=bound,
                          weight_gap=gap, control_weight_gaps=control_gaps,
                          qualifies=qualifies, fp32_repeat_mm=repeat_mm)


def parallel_phase(torch, dev, tmp):
    """--parallel_streams through the CLI, the in-process stream sweep and
    one share_weights step."""
    from dynaboa_tpu_torch.apps import benchmark
    from dynaboa_tpu_torch.apps.common import build_system
    from dynaboa_tpu_torch.config import AdaptConfig
    from dynaboa_tpu_torch.data.streams import SyntheticStream
    from dynaboa_tpu_torch.engine.runner import frame_from_item
    from dynaboa_tpu_torch.kernels import lbs as klbs
    from dynaboa_tpu_torch.parallel import streams as P

    run = os.path.join(tmp, "exps", "parallel")
    klbs.skin.launches = 0
    summary = benchmark.main([
        "--device", dev.type, "--synthetic", str(PAR_FRAMES),
        "--parallel_streams", "2", "--use_pallas_lbs", "1",
        "--expdir", os.path.join(tmp, "exps"), "--expname", "parallel"])
    torch.cuda.synchronize()
    launches = klbs.skin.launches
    with open(os.path.join(run, "res.txt")) as f:
        text = f.read().strip()
    values = [float(part.split(":")[1]) for part in text.split(", ")]
    if len(values) != 3 or not all(math.isfinite(v) for v in values):
        raise RuntimeError(f"res.txt reads {text!r}")
    frames = [p["frames"] for p in summary["per_stream"]]
    if sum(frames) != PAR_FRAMES or len(frames) != 2:
        raise RuntimeError(f"per-stream frames {frames}, expected 2 streams "
                           f"summing to {PAR_FRAMES}")
    if launches < PAR_FRAMES:
        raise RuntimeError(f"parallel run launched the kernel {launches} "
                           f"times over {PAR_FRAMES} frames")
    print(f"--parallel_streams 2: per-stream frames {frames}, res.txt "
          f"{text!r}, {summary['fps']:.3f} aggregate frames/s; kernel "
          f"launches {launches}", flush=True)

    system = build_system(AdaptConfig(use_pallas_lbs=True), None, dev)
    rates = []
    for S in (1, 2, 4, 8):
        groups = P.partition_items(
            SyntheticStream(S * PAR_PER_STREAM, seed=22), S)
        out = P.run_parallel(system.engine, system.params, groups,
                             devices=[dev], log=lambda *a: None)
        torch.cuda.synchronize()
        for k in ("mpjpe", "pampjpe", "pve"):
            if not math.isfinite(out[k]):
                raise RuntimeError(f"S={S}: {k} = {out[k]}")
        rates.append(dict(streams=S, fps=out["fps"]))
        print(f"run_parallel S={S} x {PAR_PER_STREAM} frames, round robin: "
              f"{out['fps']:.3f} aggregate frames/s (first round excluded); "
              f"MPJPE {out['mpjpe']:.2f}", flush=True)

    par = P.ParallelStreams(system.engine, [dev], share_weights=True)
    states = par.init_states(system.params, 2)
    states, outs = par.step(states, [frame_from_item(it, dev)
                                     for it in SyntheticStream(2, seed=23)])
    for k, v in states[0].params.items():
        if not torch.equal(v, states[1].params[k]):
            raise RuntimeError(f"share_weights: stream params differ at {k}")
    if torch.equal(states[0].teacher_params["fc1.weight"],
                   states[1].teacher_params["fc1.weight"]):
        raise RuntimeError("share_weights: the teachers are not private")
    print("share_weights step of 2 streams: params equal across the streams, "
          "teachers private", flush=True)
    return launches, rates


def experiments_phase(torch, dev):
    """fast_extra_updates, probe_res_factor 2 and neither, every update
    taken, at full width: ms per frame after the first."""
    from dynaboa_tpu_torch.apps.common import build_system
    from dynaboa_tpu_torch.config import AdaptConfig
    from dynaboa_tpu_torch.data.streams import SyntheticStream
    from dynaboa_tpu_torch.engine.runner import frame_from_item
    from dynaboa_tpu_torch.kernels import lbs as klbs

    base = AdaptConfig(cos_sim_threshold=-1.0, optim_steps=7,
                       use_pallas_lbs=True)
    items = list(SyntheticStream(EXP_FRAMES, seed=24))
    arms = {}
    for label, flags in (("default", {}),
                         ("fast_extra_updates", dict(fast_extra_updates=True)),
                         ("probe_res_factor=2", dict(probe_res_factor=2))):
        system = build_system(base.replace(**flags), None, dev)
        arms[label] = dict(engine=system.engine,
                           state=system.engine.init_state(system.params),
                           frames=[frame_from_item(it, dev) for it in items],
                           times=[], launches=0)
    klbs.skin.launches = 0
    # frame by frame, the arms in turns (forward, then backward), so that no
    # arm always runs first
    for i in range(EXP_FRAMES):
        for label in (list(arms) if i % 2 == 0 else list(arms)[::-1]):
            arm = arms[label]
            before = klbs.skin.launches
            t0 = time.perf_counter()
            arm["state"], out = arm["engine"].step(arm["state"],
                                                   arm["frames"][i])
            torch.cuda.synchronize()
            arm["times"].append(time.perf_counter() - t0)
            arm["launches"] += klbs.skin.launches - before
            if int(out["optim_steps"]) != base.optim_steps:
                raise RuntimeError(f"{label}: {int(out['optim_steps'])} extra "
                                   f"updates, expected {base.optim_steps}")
            for k in ("mpjpe", "pampjpe", "pve", "verts", "per_step_loss"):
                if not torch.isfinite(out[k]).all():
                    raise RuntimeError(f"{label}: non-finite {k}")
    launches = klbs.skin.launches
    ms = {}
    for label, arm in arms.items():
        if arm["launches"] == 0:
            raise RuntimeError(f"{label}: the kernel never launched")
        ms[label] = 1e3 * statistics.mean(arm["times"][1:])
        print(f"worst case, {label}: {ms[label]:.2f} ms/frame over "
              f"{EXP_FRAMES - 1} frames after the first "
              f"({arm['times'][0]:.2f} s; arms in turns), "
              f"{base.optim_steps} extra updates each; kernel launches "
              f"{arm['launches']}", flush=True)
    return launches, ms


# -- phase 13: offline preparation and fitting ---------------------------------

SMPLIFY_B, SMPLIFY_ITERS = 64, 100   # SPIN's batch; SMPLify's default
SMPLIFY_TINY = dict(num_vertices=256, batch=2, num_iters=30)
SMPLIFY_LR = 1e-2                        # SMPLify's default step size
ISO_BATCHES = (1, 8)
ISO_ATOL = 1e-4        # card vs CPU, fp32 with TF32 off (HMR tap tolerance)
PW3D_TRACKS, PW3D_TWO_PERSON, PW3D_FRAMES = 37, 13, 35_000
PW3D_J3D_ATOL = 1e-5   # metres; the CPU tests' tolerance for j3d and pose
PW3D_POSE_ATOL = 1e-5  # radians
RETRIEVAL_CROPS, RETRIEVAL_K = 256, 10
TAP_RTOL = TAP_ATOL = 1e-4   # the HMR tap tolerance of the CPU tests


def write_smpl_npz(path: str, seed: int, num_vertices: int) -> None:
    """A synthetic SMPL model in the converted-npz layout that
    ``load_smpl_npz`` reads (``tools/convert_smpl.py``'s keys)."""
    import numpy as np

    from dynaboa_tpu_torch.models.smpl import synthetic_smpl_model

    m = synthetic_smpl_model(seed, "cpu", num_vertices=num_vertices)
    np.savez(path, v_template=m.v_template.numpy(),
             shapedirs=m.shapedirs.numpy(), posedirs=m.posedirs.numpy(),
             J_regressor=m.J_regressor.numpy(), weights=m.lbs_weights.numpy(),
             kintree_parents=np.asarray(m.parents, np.int32), f=m.faces,
             J_regressor_extra=m.J_regressor_extra.numpy())


def pw3d_layout(total_frames: int, two_person: int = PW3D_TWO_PERSON,
                seed: int = 0):
    """Frames and people per sequence of the 24: ``two_person`` sequences
    with a second person, frame counts scaled so that the tracks hold about
    ``total_frames`` frames in all."""
    import numpy as np

    rng = np.random.default_rng(seed)
    people = np.ones(24, np.int64)
    people[rng.choice(24, size=two_person, replace=False)] = 2
    raw = rng.uniform(0.5, 1.5, size=24)
    frames = np.maximum(1, np.round(raw * total_frames / (raw * people).sum()))
    return [int(f) for f in frames], [int(p) for p in people]


def write_pw3d_tree(root: str, seq_frames, people, seed: int = 0):
    """The 24 test pickles of ``pw3d.SEQUENCE_ORDER`` in 3DPW's layout
    under ``root/sequenceFiles/test``, with random bodies, cameras about
    5 m in front of them and about one frame in ten ``campose_valid`` = 0.
    Returns the valid frame count of every (sequence, person) track."""
    import pickle

    import numpy as np
    import torch

    from dynaboa_tpu_torch.data.preprocess.pw3d import SEQUENCE_ORDER
    from dynaboa_tpu_torch.ops.rotations import batch_rodrigues

    rng = np.random.default_rng(seed)
    out = os.path.join(root, "sequenceFiles", "test")
    os.makedirs(out, exist_ok=True)
    valid_counts = {}
    for s, name in enumerate(SEQUENCE_ORDER):
        n, p = seq_frames[s], people[s]
        rot = batch_rodrigues(torch.as_tensor(
            rng.normal(scale=0.1, size=(n, 3)), dtype=torch.float32)).numpy()
        cam = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
        cam[:, :3, :3] = rot
        cam[:, :3, 3] = rng.normal(scale=0.1, size=(n, 3)) + [0, 0, 5.0]
        valid = [(rng.uniform(size=n) > 0.1).astype(np.int64)
                 for _ in range(p)]
        for v in valid:
            v[0] = 1                             # every track keeps a frame
        data = {
            "sequence": name[:-4], "img_frame_ids": np.arange(n),
            "poses": [rng.normal(scale=0.2, size=(n, 72)) for _ in range(p)],
            "betas": [rng.normal(scale=0.5, size=300) for _ in range(p)],
            "trans": [rng.normal(scale=0.2, size=(n, 3)) for _ in range(p)],
            "poses2d": [np.concatenate([
                rng.uniform(0, 1080, size=(n, 2, 18)),
                rng.uniform(0, 1, size=(n, 1, 18))], 1) for _ in range(p)],
            "cam_poses": cam,
            "cam_intrinsics": np.array([[1000.0, 0, 540], [0, 1000.0, 960],
                                        [0, 0, 1]]),
            "genders": ["m", "f"][:p] if s % 2 == 0 else ["f", "m"][:p],
            "campose_valid": valid,
        }
        with open(os.path.join(out, name), "wb") as f:
            pickle.dump(data, f, protocol=2)
        for pid, v in enumerate(valid):
            valid_counts[s, pid] = int(v.sum())
    return valid_counts


def smplify_inputs(torch, smpl, batch: int, seed: int):
    """Keypoints projected from known bodies at 10 m and a perturbed
    initial pose (the recipe of the JAX package's SMPLify test), as numpy:
    init_pose, init_betas, cam_t, center, keypoints."""
    import numpy as np

    from dynaboa_tpu_torch.models.smpl import smpl_forward
    from dynaboa_tpu_torch.ops.camera import perspective_projection

    rng = np.random.default_rng(seed)
    dev = smpl.v_template.device
    gt_pose = rng.normal(scale=0.15, size=(batch, 72)).astype(np.float32)
    gt_betas = rng.normal(scale=0.3, size=(batch, 10)).astype(np.float32)
    cam_t = np.tile([0.0, 0.0, 10.0], (batch, 1)).astype(np.float32)
    center = np.full((batch, 2), 112.0, np.float32)
    with torch.no_grad():
        joints = smpl_forward(smpl, torch.as_tensor(gt_betas, device=dev),
                              torch.as_tensor(gt_pose, device=dev),
                              pose2rot=True).joints
        eye = torch.eye(3, device=dev).expand(batch, 3, 3)
        j2d = perspective_projection(joints, eye,
                                     torch.as_tensor(cam_t, device=dev),
                                     5000.0, torch.as_tensor(center,
                                                             device=dev))
    kp = np.concatenate([j2d.cpu().numpy(), np.ones((batch, 49, 1))],
                        -1).astype(np.float32)
    init_pose = (gt_pose + 0.2 * rng.normal(size=(batch, 72))).astype(
        np.float32)
    return [init_pose, np.zeros((batch, 10), np.float32), cam_t, center, kp]


def smplify_phase(torch, dev):
    """SMPLify at SPIN's batch on the card from the shipped GMM prior and
    the V = 6890 synthetic body; then a tiny fit on the card and on the CPU
    from the same inputs."""
    import numpy as np

    from dynaboa_tpu_torch.losses.priors import (default_gmm_path,
                                                 load_gmm_prior)
    from dynaboa_tpu_torch.models.smpl import synthetic_smpl_model
    from dynaboa_tpu_torch.smplify import SMPLify

    smpl = synthetic_smpl_model(20, dev)
    fitter = SMPLify(smpl, load_gmm_prior(default_gmm_path(), dev),
                     num_iters=SMPLIFY_ITERS)
    args = smplify_inputs(torch, smpl, SMPLIFY_B, seed=0)
    before = fitter.get_fitting_loss(*args)
    # a 2-iteration fit first: the first backward passes in a process pay
    # for library set-up, which is no part of a fit's steady cost
    SMPLify(smpl, fitter.prior, num_iters=2)(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fitter(*args)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    for name, o in zip(("vertices", "joints", "pose", "betas", "camera_t",
                        "reprojection"), out):
        if o.device != dev or not torch.isfinite(o).all():
            raise RuntimeError(f"SMPLify {name}: on {o.device}, finite "
                               f"{bool(torch.isfinite(o).all())}")
    loss_before, loss_after = float(before.sum()), float(out[5].sum())
    if not loss_after < loss_before:
        raise RuntimeError(f"SMPLify: reprojection {loss_after} after the "
                           f"fit, {loss_before} before")
    its = 2 * SMPLIFY_ITERS / fit_s
    print(f"SMPLify B={SMPLIFY_B} V=6890, {SMPLIFY_ITERS} iterations per "
          f"stage: {fit_s:.3f} s per fit, {its:.1f} iterations/s; "
          f"reprojection {loss_before:.1f} -> {loss_after:.1f}", flush=True)

    tiny = SMPLIFY_TINY

    def tiny_fit(d):
        small = synthetic_smpl_model(20, d, num_vertices=tiny["num_vertices"])
        f = SMPLify(small, load_gmm_prior(default_gmm_path(), d),
                    num_iters=tiny["num_iters"])
        return [o.cpu().numpy() for o in f(*smplify_inputs(
            torch, small, tiny["batch"], seed=1))]

    card, cpu = tiny_fit(dev), tiny_fit(torch.device("cpu"))
    bound = tiny["num_iters"] * SMPLIFY_LR
    gaps = {}
    # the global orientation steps in both stages, the rest in one
    for name, i, sl, b in (("global_orient", 2, np.s_[:, :3], 2 * bound),
                           ("body_pose", 2, np.s_[:, 3:], bound),
                           ("betas", 3, np.s_[:], bound),
                           ("camera_t", 4, np.s_[:], bound)):
        gaps[name] = float(np.abs(card[i][sl] - cpu[i][sl]).max())
        if not gaps[name] <= b:
            raise RuntimeError(f"SMPLify card vs CPU: {name} differs by "
                               f"{gaps[name]}, bound {b}")
    print(f"SMPLify V={tiny['num_vertices']} B={tiny['batch']} "
          f"{tiny['num_iters']} iterations, card vs CPU: largest gaps "
          f"{gaps} within num_iters * lr = {bound}", flush=True)
    return dict(smplify_s_per_fit=fit_s, smplify_iters_per_s=its,
                smplify_reproj_before=loss_before,
                smplify_reproj_after=loss_after,
                smplify_card_vs_cpu_max_gap=max(gaps.values()))


def hmriso_phase(torch, dev):
    """The dual-head BatchNorm HMRISO at full width, seeded weights and
    running statistics, eval mode: card against CPU, ms per forward."""
    import copy

    from dynaboa_tpu_torch.models.hmr import HMRISO, init_weights_

    gen = torch.Generator().manual_seed(22)
    cpu_net = init_weights_(HMRISO(), gen).eval()
    with torch.no_grad():
        for m in cpu_net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    net = copy.deepcopy(cpu_net).to(dev)
    result = {}
    for batch in ISO_BATCHES:
        x = torch.randn(batch, 3, 224, 224, generator=gen)
        with torch.no_grad():
            want = cpu_net(x)
            xd = x.to(dev)
            got = net(xd)
            ms = time_cuda(lambda: net(xd), iters=20)
        err = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))
        if len(got) != 6 or not all(torch.isfinite(g).all() for g in got):
            raise RuntimeError(f"HMRISO B={batch}: outputs not finite")
        if not err <= ISO_ATOL:
            raise RuntimeError(f"HMRISO B={batch}: card vs CPU {err} > "
                               f"{ISO_ATOL}")
        print(f"HMRISO B={batch}: {ms:.3f} ms per forward; six outputs "
              f"finite, card vs CPU max abs err {err:.3e} "
              f"(tolerance {ISO_ATOL})", flush=True)
        result[f"hmriso_ms_b{batch}"] = ms
        result[f"hmriso_max_abs_err_b{batch}"] = err
    return result


PW3D_CHILD = r"""
import json, time
from dynaboa_tpu_torch.apps import process_data
from dynaboa_tpu_torch.data.preprocess import pw3d
spent = {"decode_s": 0.0}
def timed(fn):
    def wrap(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)   # ends in a copy to the host, which waits
        spent["decode_s"] += time.perf_counter() - t0
        return out
    return wrap
pw3d._decode, pw3d._root_to_aa = timed(pw3d._decode), timed(pw3d._root_to_aa)
t0 = time.perf_counter()
process_data.main(["--dataset", "3dpw"])
spent["extract_s"] = time.perf_counter() - t0
print("PW3D_CHILD " + json.dumps(spent))
"""


def pw3d_phase(torch, tmp, total_frames: int = PW3D_FRAMES):
    """The process_data CLI's 3DPW branch in a process of its own, with
    PW3D_ROOT and SMPL_MODEL_DIR set and the working directory in a temp
    dir, over a synthetic test split of 37 tracks; then one sequence again
    on the CPU."""
    import numpy as np

    from dynaboa_tpu_torch.data.preprocess.pw3d import (SEQUENCE_ORDER,
                                                        pw3d_extract)
    from dynaboa_tpu_torch.models.smpl import load_smpl_npz

    root, smpl_dir = os.path.join(tmp, "3dpw"), os.path.join(tmp, "smpl")
    work = os.path.join(tmp, "work")
    os.makedirs(smpl_dir)
    os.makedirs(work)
    for seed, g in ((11, "male"), (12, "female")):
        write_smpl_npz(os.path.join(smpl_dir, f"smpl_{g}.npz"), seed, 6890)
    seq_frames, people = pw3d_layout(total_frames)
    valid = write_pw3d_tree(root, seq_frames, people)
    if len(valid) != PW3D_TRACKS:
        raise RuntimeError(f"{len(valid)} tracks in the synthetic split")
    frames = sum(valid.values())

    env = dict(os.environ, PW3D_ROOT=root, SMPL_MODEL_DIR=smpl_dir)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.dirname(os.path.abspath(__file__)),
                    env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", PW3D_CHILD], cwd=work,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"process_data --dataset 3dpw failed:\n"
                           f"{proc.stderr[-4000:]}")
    spent = json.loads(proc.stdout.strip().splitlines()[-1].split(" ", 1)[1])
    out_dir = os.path.join(work, "data", "dataset_extras")
    written = sorted(os.listdir(out_dir))
    if len(written) != PW3D_TRACKS:
        raise RuntimeError(f"{len(written)} archives written, expected "
                           f"{PW3D_TRACKS}")
    for (s, p), n in valid.items():
        d = np.load(os.path.join(out_dir, f"3dpw_{s}_{p}.npz"))
        for k in ("imgname", "pose", "j3d", "j2d", "op_j2d", "center"):
            if d[k].shape[0] != n:
                raise RuntimeError(f"3dpw_{s}_{p}.npz {k}: {d[k].shape[0]} "
                                   f"frames, {n} valid")
        if not np.isfinite(d["j3d"]).all():
            raise RuntimeError(f"3dpw_{s}_{p}.npz: non-finite j3d")

    # sequence 0 again on the CPU: the same pickle, every other sequence
    # cut to one frame
    small = os.path.join(tmp, "3dpw_cpu")
    write_pw3d_tree(small, [1] * 24, people)
    shutil.copy(os.path.join(root, "sequenceFiles", "test", SEQUENCE_ORDER[0]),
                os.path.join(small, "sequenceFiles", "test",
                             SEQUENCE_ORDER[0]))
    cpu = torch.device("cpu")
    cpu_out = os.path.join(tmp, "cpu_out")
    with contextlib.redirect_stdout(io.StringIO()):     # a line per track
        pw3d_extract(small, cpu_out,
                     load_smpl_npz(os.path.join(smpl_dir, "smpl_male.npz"),
                                   cpu),
                     load_smpl_npz(os.path.join(smpl_dir, "smpl_female.npz"),
                                   cpu))
    gaps = {"j3d": 0.0, "pose": 0.0}
    for p in range(people[0]):
        a = np.load(os.path.join(out_dir, f"3dpw_0_{p}.npz"))
        b = np.load(os.path.join(cpu_out, f"3dpw_0_{p}.npz"))
        for k in gaps:
            gaps[k] = max(gaps[k], float(np.abs(a[k] - b[k]).max()))
    if gaps["j3d"] > PW3D_J3D_ATOL or gaps["pose"] > PW3D_POSE_ATOL:
        raise RuntimeError(f"3DPW sequence 0, card vs CPU: {gaps}")
    fps = frames / spent["extract_s"]
    host_s = spent["extract_s"] - spent["decode_s"]
    print(f"3DPW extraction: {PW3D_TRACKS} tracks, {frames} valid frames of "
          f"{sum(f * p for f, p in zip(seq_frames, people))}, "
          f"{spent['extract_s']:.2f} s in the CLI ({wall:.2f} s with the "
          f"process start): {fps:.1f} frames/s; decode on the card "
          f"{spent['decode_s']:.2f} s, host numpy and I/O {host_s:.2f} s; "
          f"sequence 0 ({seq_frames[0]} frames) card vs CPU: j3d "
          f"{gaps['j3d']:.2e} m, pose {gaps['pose']:.2e}", flush=True)
    return dict(pw3d_frames=frames, pw3d_frames_per_s=fps,
                pw3d_extract_s=spent["extract_s"],
                pw3d_decode_s=spent["decode_s"], pw3d_host_s=host_s,
                pw3d_card_vs_cpu_j3d=gaps["j3d"],
                pw3d_card_vs_cpu_pose=gaps["pose"])


def retrieval_phase(torch, dev):
    """The retrieval store's features and clusters over 256 synthetic crops
    through the full-width HMR (seed 22), k = 10; 8 crops' features card
    against CPU."""
    import copy

    import numpy as np

    from dynaboa_tpu_torch.models.hmr import HMR, init_weights_
    from dynaboa_tpu_torch.tools.build_retrieval import features_and_clusters

    cpu_net = init_weights_(HMR(), torch.Generator().manual_seed(22)).eval()
    net = copy.deepcopy(cpu_net).to(dev)
    gen = torch.Generator(device=dev).manual_seed(22)
    images = torch.randn(RETRIEVAL_CROPS, 224, 224, 3, generator=gen,
                         device=dev)
    features_and_clusters(images[:8], net, 2)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    centers, assign, feats = features_and_clusters(images, net, RETRIEVAL_K)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    norms = np.linalg.norm(centers, axis=1)
    if centers.shape != (RETRIEVAL_K, feats.shape[1]) or \
            not np.allclose(norms, 1.0, atol=1e-5):
        raise RuntimeError(f"retrieval centers {centers.shape}, norms {norms}")
    if assign.shape != (RETRIEVAL_CROPS,) or assign.min() < 0 or \
            assign.max() >= RETRIEVAL_K:
        raise RuntimeError(f"retrieval assignments {assign.shape} in "
                           f"[{assign.min()}, {assign.max()}]")
    with torch.no_grad():
        want = cpu_net(images[:8].cpu().permute(0, 3, 1, 2))[3][5].numpy()
    err = float(np.abs(feats[:8] - want).max())
    np.testing.assert_allclose(feats[:8], want, rtol=TAP_RTOL, atol=TAP_ATOL)
    rate = RETRIEVAL_CROPS / secs
    print(f"retrieval features: {RETRIEVAL_CROPS} crops in {secs:.3f} s, "
          f"{rate:.1f} crops/s; k={RETRIEVAL_K} cluster sizes "
          f"{np.bincount(assign, minlength=RETRIEVAL_K).tolist()}, centers "
          f"unit-norm; tap 5 card vs CPU max abs err {err:.3e}", flush=True)
    return dict(retrieval_crops_per_s=rate, retrieval_s=secs,
                retrieval_tap5_max_abs_err=err)


def offline_phase(torch, dev, tmp):
    """Phase 13: SMPLify, HMRISO, the 3DPW extraction and the retrieval
    features at full size.  None of these paths runs the skinning kernel
    (SMPLify takes gradients through SMPL, the 3DPW decode runs without
    it); its count over the phase is reported."""
    from dynaboa_tpu_torch.kernels import lbs as klbs

    klbs.skin.launches = 0
    offline = {}
    for part, fn in (("a SMPLify", lambda: smplify_phase(torch, dev)),
                     ("b HMRISO", lambda: hmriso_phase(torch, dev)),
                     ("c 3DPW extraction", lambda: pw3d_phase(torch, tmp)),
                     ("d retrieval features",
                      lambda: retrieval_phase(torch, dev))):
        print(f"--- 13{part}", flush=True)
        t0 = time.perf_counter()
        offline.update(fn())
        offline[f"part_{part.split()[0]}_s"] = time.perf_counter() - t0
    offline["lbs_skin_launches"] = klbs.skin.launches
    return offline


def parity_phase(torch, dev):
    """Phase 14: the full-width parity harness on the card against the
    committed JAX record.  Returns the kernel's launches over the phase and
    a summary: per arm its seconds, step counts, near-threshold frames and
    every check's measured gap beside its bound."""
    from dynaboa_tpu_torch.kernels import lbs as klbs
    from dynaboa_tpu_torch.tools import fullscale_parity as fp

    record = fp.load_record()
    meta = record["meta"]
    klbs.skin.launches = 0
    t0 = time.perf_counter()
    run = fp.run_all(dev, meta["size"], meta["n_frames"],
                     centers=record["centers"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = klbs.skin.launches
    result = fp.compare(record, run)
    for line in fp.report_lines(result):
        print(line, flush=True)
    failed = fp.failures(result)
    if failed:
        recipe = [f for f in failed if "/recipe/" in f]
        raise RuntimeError(
            f"full-width parity against the JAX record failed: {failed}"
            + (" (a recipe fault: the inputs differ from the record's)"
               if recipe else ""))
    frames = meta["n_frames"] * len(run["arms"])
    if launches < frames:
        raise RuntimeError(f"skinning kernel launched {launches} times over "
                           f"{frames} parity frames")
    summary = {"seconds": seconds, "record": {
        k: meta[k] for k in ("jax", "jaxlib", "backend", "recipe_version")}}
    for arm, a in result["arms"].items():
        summary[arm] = {
            "seconds": run["meta"]["arms"][arm]["seconds"],
            "steps": a["steps"], "jax_steps": a["jax_steps"],
            "near_threshold": [(x["frame"], x["jax_steps"], x["port_steps"],
                                x["min_margin"]) for x in a["near_threshold"]],
            # measured, bound, the largest allowance, the worst share of
            # the allowance, the frame the reference's spread widened it
            "gaps": {c["field"] + (f" ({c['leaf']})" if c.get("leaf") else ""):
                     [c["measured"], c["bound"], c["allowance"], c["share"],
                      c.get("widened_from")]
                     for c in a["checks"]}}
    print(f"parity: {len(run['arms'])} arms x {meta['n_frames']} frames at "
          f"{meta['size']} size in {seconds:.1f} s ("
          + ", ".join(f"{arm} {summary[arm]['seconds']:.1f} s"
                      for arm in run["arms"])
          + f"); every check within its allowance; kernel launches "
          f"{launches}", flush=True)
    return launches, summary


# -- phase 15: the measuring and endurance drivers ---------------------------

# reduced counts: at 8 frames per worst-case run, realistic-gate run and
# curve point and 24 runner frames the bench took 332 s of the phase on the
# H100; the script must stay well inside its time limit on a slower card
BENCH_ARGS = ("--full", "--repeats", "3", "--stream_frames", "16",
              "--worst_frames", "4", "--realistic_frames", "4",
              "--curve_frames", "4", "--runner_frames", "16", "--chunks", "1",
              "--window_steps", "4", "--parallel_frames", "8")
# bench.py:523-542 and :597-607, the JAX bench's keys
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "compute_dtype",
              "streaming_fps", "streaming_fps_runs", "chunk_size",
              "worst_case_streaming_fps", "worst_case_extra_steps",
              "realistic_gate_fps", "fps_vs_extra_steps", "runner_steady_fps",
              "runner_steady_fps_runs", "fp32_streaming_fps",
              "bf16_traj_mpjpe_rel", "bf16_traj_mpjpe_rel_chaos_controls",
              "bf16_traj_weight_drift_vs_adam_bound")
BENCH_FULL_KEYS = ("chunked_fps", "windowed8_aggregate_fps",
                   "parallel_1dev_fps", "worst_case_experiments_fps")
SOAK_FRAMES, SOAK_EVERY = 96, 24
SOAK_PAR_FRAMES, SOAK_PAR_STREAMS = 1000, 8


def _finite(x) -> bool:
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, list):
        return all(_finite(v) for v in x)
    return not isinstance(x, float) or math.isfinite(x)


def drivers_phase(torch, tmp):
    """Phase 15: the bench, the soak's two arms, a cold start and a sweep.
    Returns the kernel's launches over the bench and over the soak, and a
    summary."""
    from dynaboa_tpu_torch.kernels import lbs as klbs
    from dynaboa_tpu_torch.tools import bench, bench_coldstart, soak, sweep

    out, seconds = {}, {}

    print("--- 15a bench --full", flush=True)
    t0 = time.perf_counter()
    klbs.skin.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = bench.main(["--device", "cuda", "--out",
                          os.path.join(tmp, "bench.json"), *BENCH_ARGS])
    torch.cuda.synchronize()
    launches_bench = klbs.skin.launches
    seconds["bench"] = time.perf_counter() - t0
    print(buf.getvalue(), end="", flush=True)
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    if len(lines) != 2:
        raise RuntimeError(f"bench printed {len(lines)} lines, expected 2")
    missing = (set(BENCH_KEYS) | set(bench.PORT_KEYS)) - set(lines[0])
    missing |= set(BENCH_FULL_KEYS) - set(lines[1])
    if missing:
        raise RuntimeError(f"bench lines lack {sorted(missing)}")
    if not _finite(res):
        raise RuntimeError(f"bench result not finite: {res}")
    if res["backend"] != "cuda" or res["skin_kernel_launches"] <= 0 \
            or launches_bench != res["skin_kernel_launches"]:
        raise RuntimeError(f"bench on {res['backend']}, kernel launches "
                           f"{res['skin_kernel_launches']} (counted "
                           f"{launches_bench})")
    out["bench"] = {k: res[k] for k in (
        "value", "compute_dtype", "streaming_fps_runs", "fp32_streaming_fps",
        "bf16_streaming_fps", "worst_case_streaming_fps",
        "realistic_gate_fps", "fps_vs_extra_steps", "runner_steady_fps_runs",
        "bf16_traj_mpjpe_rel", "bf16_traj_mpjpe_rel_chaos_controls",
        "bf16_traj_weight_drift_vs_adam_bound",
        "bf16_traj_nondeterministic_ops", *BENCH_FULL_KEYS, "runs",
        "skin_kernel_launches")}
    print(f"bench: flagship {res['compute_dtype']} {res['value']} frames/s "
          f"(runs {res['streaming_fps_runs']}; fp32 "
          f"{res['fp32_streaming_fps']}, bf16 {res['bf16_streaming_fps']} in "
          f"the qualification); kernel launches {launches_bench}; "
          f"{seconds['bench']:.1f} s", flush=True)

    print("--- 15b soak, sequential, full width, --bitexact", flush=True)
    t0 = time.perf_counter()
    klbs.skin.launches = 0
    seq = soak.main([
        "sequential", "--device", "cuda", "--bitexact",
        "--frames", str(SOAK_FRAMES), "--checkpoint_every", str(SOAK_EVERY),
        "--rss_every", "8", "--log_every", "1000",
        "--expdir", os.path.join(tmp, "soak"),
        "--out", os.path.join(tmp, "soak.json")])
    seconds["soak_sequential"] = time.perf_counter() - t0
    if not (seq["bitexact_resume"]["exact"] and seq["auto_resets"] >= 1
            and seq["every_frame_seen_once"]):
        raise RuntimeError(f"sequential soak: {seq}")

    print("--- 15c soak, parallel, tiny network", flush=True)
    t0 = time.perf_counter()
    par = soak.main([
        "parallel", "--device", "cuda", "--tiny",
        "--frames", str(SOAK_PAR_FRAMES), "--streams", str(SOAK_PAR_STREAMS),
        "--out", os.path.join(tmp, "soak.json")])
    torch.cuda.synchronize()
    launches_soak = klbs.skin.launches
    seconds["soak_parallel"] = time.perf_counter() - t0
    if par["frames_run"] != SOAK_PAR_FRAMES:
        raise RuntimeError(f"parallel soak: {par}")
    if launches_soak == 0:
        raise RuntimeError("the soak never launched the kernel")
    out["soak"] = {"sequential_bitexact": seq, "parallel": par}

    print("--- 15d cold start, sweep", flush=True)
    # the children share the card with this process: hand back the memory
    # its allocator keeps cached from the phases before (the graph pools of
    # dropped states among it), or a child meets a full card
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["coldstart"] = bench_coldstart.main(["--runs", "1"])
    seconds["coldstart"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path = sweep.main([
        "--grid", "interval=2,5", "--base",
        "--device cuda --tiny 1 --synthetic 4 --use_pallas_lbs 1",
        "--out", os.path.join(tmp, "sweep")])
    seconds["sweep"] = time.perf_counter() - t0
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    if len(rows) != 2 or not all(math.isfinite(r["mpjpe"])
                                 and r["frames"] == 4 for r in rows):
        raise RuntimeError(f"sweep records: {rows}")
    out["sweep"] = [{k: r[k] for k in ("combo", "mpjpe", "fps", "wall_s")}
                    for r in rows]
    out["seconds"] = seconds
    print(f"soak: sequential exact {seq['bitexact_resume']['exact']}, "
          f"{seq['auto_resets']} resets, steady {seq['fps_steady']} frames/s;"
          f" parallel {par['frames_run']} frames at {par['aggregate_fps']} "
          f"aggregate frames/s, RSS {par['rss_mb']}; kernel launches "
          f"{launches_soak}; cold start {out['coldstart']['runs']}; "
          f"seconds {seconds}", flush=True)
    return launches_bench, launches_soak, out


# -- phase 16: the attribution and app drivers --------------------------------

FLOOR_ITERS = 8
# the JAX tool's order; each variant builds a full-width system
ABLATE_VARIANTS = ("base", "no_teacher", "fp32", "no_inner")
ABLATE_FRAMES = 4
STREAM_APP_FRAMES = 24
RASTER_FRAMES = 20
# the update floor's arms whose FlopCounterMode count must be positive
# (matmuls and convolutions); the others may have none
FLOP_ARMS = ("grad(batched fwd+bwd)", "fwd_batched", "fwd1(probe/teacher)")


def _positive(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x) and x > 0


def check_update_floor(res) -> None:
    """Every time and count of ``profile_update_floor`` finite and positive;
    the decode arm launched the kernel."""
    bad = [k for k in ("full_step_ms_per_frame", "full_step_ms_per_update",
                       "sum_ms", "device_sum_ms", "grad_minus_fwd_ms")
           if not _positive(res[k])]
    for label, arm in res["arms"].items():
        for k in ("ms_per_iter", "device_ms_per_iter", "kernels_per_iter"):
            if not _positive(arm[k]):
                bad.append(f"{label}.{k}")
        if not 0 <= arm["idle_share"] < 1:
            bad.append(f"{label}.idle_share")
        counted = arm["gflop_per_iter"] is not None
        if (label in FLOP_ARMS or counted) and not (
                _positive(arm["gflop_per_iter"]) and _positive(arm["sol_ms"])
                and _positive(arm["sol_share"])):
            bad.append(f"{label}.gflop_per_iter")
    if bad or res["backend"] != "cuda":
        raise RuntimeError(f"update floor ({res['dtype']}) on "
                           f"{res['backend']}: not finite and positive: "
                           f"{bad}")
    if res["arms"]["decode_metrics"]["skin_kernel_launches"] <= 0:
        raise RuntimeError("the update floor's decode_metrics arm never "
                           "launched the skinning kernel")


def attribution_phase(torch, tmp):
    """Phase 16: the per-update attribution in fp32 and bf16, the worst-case
    ablation, the stream-app timer and the rasterizer timer.  Returns the
    kernel's launches over the first three and a summary."""
    from dynaboa_tpu_torch.kernels import lbs as klbs
    from dynaboa_tpu_torch.tools import (ablate_worstcase, bench_raster,
                                         bench_stream_app,
                                         profile_update_floor)

    out, seconds, launches = {}, {}, {}

    print("--- 16a profile_update_floor, fp32 and bf16", flush=True)
    t0 = time.perf_counter()
    klbs.skin.launches = 0
    out["update_floor"] = {}
    for dtype in ("float32", "bfloat16"):
        res = profile_update_floor.main([
            "--device", "cuda", "--dtype", dtype, "--use_pallas_lbs", "1",
            "--iters", str(FLOOR_ITERS),
            "--trace_dir", os.path.join(tmp, "update_floor")])
        check_update_floor(res)
        out["update_floor"][dtype] = res
    torch.cuda.synchronize()
    launches["update_floor"] = klbs.skin.launches
    seconds["update_floor"] = time.perf_counter() - t0

    print("--- 16b ablate_worstcase", flush=True)
    t0 = time.perf_counter()
    klbs.skin.launches = 0
    res = ablate_worstcase.main([
        "--device", "cuda", "--use_pallas_lbs", "1",
        "--variants", ",".join(ABLATE_VARIANTS),
        "--frames", str(ABLATE_FRAMES), "--repeats", "1"])
    torch.cuda.synchronize()
    launches["ablate"] = klbs.skin.launches
    seconds["ablate"] = time.perf_counter() - t0
    rows = {r["label"]: r for r in res["variants"]}
    if list(rows) != list(ABLATE_VARIANTS):
        raise RuntimeError(f"ablation ran {list(rows)}, asked for "
                           f"{list(ABLATE_VARIANTS)}")
    bad = [f"{label}.{k}" for label, r in rows.items()
           for k in ("ms_per_frame", "fps") if not _positive(r[k])]
    bad += [k for k, v in res["ms_per_update_by_component"].items()
            if not math.isfinite(v)]
    if bad or res["backend"] != "cuda":
        raise RuntimeError(f"ablation on {res['backend']}: {bad}")
    out["ablate"] = res

    print("--- 16c bench_stream_app", flush=True)
    t0 = time.perf_counter()
    klbs.skin.launches = 0
    res = bench_stream_app.main([
        "--device", "cuda", "--use_pallas_lbs", "1", "--fused", "1",
        "--frames", str(STREAM_APP_FRAMES)])
    torch.cuda.synchronize()
    launches["stream_app"] = klbs.skin.launches
    seconds["stream_app"] = time.perf_counter() - t0
    if not (res["steady_parsed"] and _positive(res["fps"])):
        raise RuntimeError(f"stream app: no steady frames/s from the app's "
                           f"own line: {res}")
    out["stream_app"] = res

    print("--- 16d bench_raster", flush=True)
    t0 = time.perf_counter()
    res = bench_raster.main(["--frames", str(RASTER_FRAMES)])
    seconds["raster"] = time.perf_counter() - t0
    if res["backend"] != "native" or not all(
            _positive(a["ms_per_frame"]) for a in res["arms"].values()):
        raise RuntimeError(f"raster: {res}")
    out["raster"] = res

    for path, n in launches.items():
        if n == 0:
            raise RuntimeError(f"phase 16's {path} never launched the "
                               "skinning kernel")
    out["seconds"] = seconds
    f32, b16 = (out["update_floor"][d] for d in ("float32", "bfloat16"))
    print(f"attribution: ms/update (wall, device sum) fp32 "
          f"{f32['full_step_ms_per_update']:.2f} "
          f"({f32['device_sum_ms']:.2f}), bf16 "
          f"{b16['full_step_ms_per_update']:.2f} "
          f"({b16['device_sum_ms']:.2f}); ablation "
          f"{out['ablate']['ms_per_update_by_component']}; stream app "
          f"{out['stream_app']['fps']} frames/s; kernel launches "
          f"{launches}; seconds {seconds}", flush=True)
    return launches, out


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
    from dynaboa_tpu_torch.kernels import group_norm as kgn

    built_gn = kgn.library(0)
    print(f"built {built_gn.path} in {built_gn.seconds:.1f} s", flush=True)
    print("\n".join(line for line in built_gn.ptxas_log.splitlines()
                    if any(w in line for w in ("Compiling", "registers",
                                               "smem", "spill"))),
          flush=True)

    from dynaboa_tpu_torch.kernels import conv as kc

    built_conv = kc.library(0)
    print(f"built {built_conv.path} in {built_conv.seconds:.1f} s",
          flush=True)
    print("\n".join(line for line in built_conv.ptxas_log.splitlines()
                    if any(w in line for w in ("Compiling", "registers",
                                               "smem", "spill"))),
          flush=True)

    phase("2 kernel vs plain, V=6890")
    max_err, times, geometries = kernel_phase(torch, dev)
    phase("2b GroupNorm kernel vs ATen and plain, ResNet-50 shapes")
    gn_err, gn_rows, gn_totals = group_norm_phase(torch, dev)
    phase("2c convolution kernel vs ATen and plain, ResNet-50 shapes")
    conv_err, conv_rows, conv_totals = conv_phase(torch, dev)

    phase(f"3 main path, {N_FRAMES} frames at full width")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches, main_summary = main_path_phase(torch, tmp)
        gn_launches = main_summary["group_norm_launches"]
        conv_launches = main_summary["conv_launches"]
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
        phase("10 bf16 at full width")
        # the later phases do not depend on this one: a failure is raised
        # once they have run, so that one run reports all of them
        bf16_error = None
        try:
            launches_b, _ = bf16_phase(torch, dev, tmp, main_summary)
        except Exception as e:
            traceback.print_exc()
            bf16_error, launches_b = e, None
        phase("11 parallel streams at full width")
        launches_p, _ = parallel_phase(torch, dev, tmp)
        phase("12 worst-case experiment flags at full width")
        launches_e, _ = experiments_phase(torch, dev)
        phase("13 offline preparation and fitting at full size")
        offline = offline_phase(torch, dev, tmp)
        phase("14 full-width parity against the JAX record")
        launches_f, parity = parity_phase(torch, dev)
        phase("15 drivers: bench, soak, cold start, sweep")
        launches_bd, launches_sk, drivers = drivers_phase(torch, tmp)
        phase("16 attribution and app drivers: update floor, ablation, "
              "stream app, rasterizer")
        launches_at, attribution = attribution_phase(torch, tmp)
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
                             "stream": launches_s, "save_res": launches_o,
                             "bf16": launches_b, "parallel": launches_p,
                             "experiments": launches_e,
                             "fullscale_parity": launches_f,
                             "bench": launches_bd, "soak": launches_sk,
                             **launches_at},
        "geometries": geometries,
    }, {
        "name": "group_norm", "route": "cuda",
        "source": "dynaboa_tpu_torch/csrc/group_norm.cu",
        "replaces": None, "launches": gn_launches,
        "max_rel_err": gn_err, "library_call": "nnf.group_norm",
        "bound_by": "bytes", "shapes": gn_rows, **gn_totals,
    }, {
        "name": "conv_fprop", "route": "cuda",
        "source": "dynaboa_tpu_torch/csrc/conv_fprop.cu",
        "replaces": None, "launches": conv_launches,
        "max_rel_err": conv_err, "library_call": "nnf.conv2d",
        "bound_by": "operations", "shapes": conv_rows, **conv_totals,
    }]
    print(info)
    print(json.dumps({"offline": offline}))
    print(json.dumps({"parity": parity}))
    print(json.dumps({"drivers": drivers}))
    print(json.dumps({"attribution": attribution}))
    print(json.dumps({"kernels": kernels}))
    if bf16_error is not None:
        raise RuntimeError("phase 10 (bf16 at full width) failed; the "
                           "traceback is printed above") from bf16_error
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
