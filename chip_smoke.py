#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dynaboa_tpu_torch) on one CUDA card.

  python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:
  0. the card: name and power limit from nvidia-smi
  1. build the Hopper skinning kernel from dynaboa_tpu_torch/csrc with nvcc
  2. the kernel against its plain PyTorch version at full SMPL size
     (V = 6890), N = 1 and 3, identity and random poses; times at N = 1
  3. the main path: the port's 3DPW benchmark CLI, 8 synthetic frames of
     per-frame dynamic bilevel adaptation at full width (ResNet-50-GN,
     224^2, V = 6890) with the skinning kernel on; the kernel's launch count
     over that run must reach the frame count
  4. the same CLI at a tiny size on the card and on the CPU from the same
     seed, every update taken: step counts, losses and metrics must agree

The line before the last is a JSON object describing every kernel of the
path; the last line is {"ok": true, "device": {...}}.  Without a CUDA card
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
KERNEL_ATOL = 1e-5     # fp32, different summation order over 207 + 24 terms
KERNEL_RTOL = 1e-5
LOSS_RTOL = 2e-3       # the port's CPU/JAX parity tolerance for losses
METRIC_ATOL_MM = 0.05


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
        return (tsmpl.pose_features(rot), sk.posedirs_k,
                v_shaped.contiguous(), sk.weights_k, rel.contiguous())

    max_err = 0.0
    with torch.no_grad():
        for n, identity in ((1, True), (1, False), (3, False), (3, True)):
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

        # times at the main path's shape (N = 1), hot and cold L2
        args = plain_args(*inputs(1, False))
        scrub = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device=dev)

        def flush():
            scrub.zero_()

        times = {}
        for label, fl in (("hot", None), ("cold", flush)):
            # plain, kernel, kernel, plain: both see the same conditions
            p1 = time_cuda(lambda: klbs.skin_plain(*args), flush=fl)
            k1 = time_cuda(lambda: klbs.skin(*args), flush=fl)
            k2 = time_cuda(lambda: klbs.skin(*args), flush=fl)
            p2 = time_cuda(lambda: klbs.skin_plain(*args), flush=fl)
            times[label] = (min(k1, k2), min(p1, p2))
            print(f"lbs_skin N=1 {label} L2: kernel {times[label][0] * 1e3:.2f}"
                  f" us  plain {times[label][1] * 1e3:.2f} us "
                  f"(device time: median of 200 CUDA-event timings, better of 2 "
                  f"rounds)",
                  flush=True)
        torch.cuda.synchronize()
    return max_err, times


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
                    if "registers" in line or "smem" in line), flush=True)

    phase("2 kernel vs plain, V=6890")
    max_err, times = kernel_phase(torch, dev)

    phase(f"3 main path, {N_FRAMES} frames at full width")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches, _ = main_path_phase(torch, tmp)
        phase("4 tiny CLI run, cuda vs cpu")
        cross_device_phase(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


    kernels = [{
        "name": "lbs_skin", "route": "cuda",
        "source": "dynaboa_tpu_torch/csrc/lbs_skin.cu",
        "replaces": "dynaboa_tpu/kernels/lbs.py:45",
        "launches": launches, "max_abs_err": max_err,
        "ms": times["cold"][0], "plain_ms": times["cold"][1],
    }]
    print(info)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
