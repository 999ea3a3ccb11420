#!/usr/bin/env python
"""Attribute the worst-case per-update cost of the step to its parts, on one
CUDA card (counterpart of ``tools/profile_update_floor.py``).

First the ``[full-step]`` line: the real ``engine.step`` with every update
taken (threshold -1), one warm-up frame, then 12 frames synchronised at
both ends; ms per frame, updates per frame and ms per update.  Then each
part of one dynamic update (reference protocol: dynaboa_benchmark.py:147-192)
runs alone, through the engine's own methods on the same inputs:

* ``grad(batched fwd+bwd)`` -- ``_level_loss`` of the upper level and
                               ``torch.autograd.grad`` over the batched
                               frame + history + exemplar rows, then
                               ``p -= 1e-6 * g`` in place
* ``fwd_batched``           -- the same batched forward, no backward
* ``fwd1(probe/teacher)``   -- a B = 1 forward (the teacher forward and the
                               post-update probe each cost one)
* ``adam_ema``              -- ``_outer_update`` + ``_ema_teacher`` over the
                               full tree, constant grads of 1e-6, on a copy
                               of the state
* ``decode_metrics``        -- the B = 1 no-grad SMPL decode (the skinning
                               kernel with ``--use_pallas_lbs 1``) and the
                               MPJPE / PA-MPJPE / PVE record

Each arm reports, over ``--iters`` iterations after one warm-up iteration:

* ``ms_per_iter``: host wall time, synchronised at both ends, with nothing
  else running (the profiler is off);
* ``device_ms_per_iter``, ``kernels_per_iter``, ``idle_share``,
  ``host_syncs_per_iter``: from a ``torch.profiler`` trace of
  ``PROFILE_ITERS`` further iterations (``apps/profile.py:device_busy``:
  busy is the union of the kernel, memcpy and memset intervals, idle the
  rest of their span; the profiler's own host cost widens the span, so
  ``device_ms_per_iter / ms_per_iter`` is the busy share of the unprofiled
  loop).  A host sync is a ``cudaStreamSynchronize`` or
  ``cudaEventSynchronize`` call (a read of a device value on the host);
  the loop's closing ``torch.cuda.synchronize`` is not one;
* ``gflop_per_iter``: ``torch.utils.flop_counter.FlopCounterMode`` over one
  iteration.  It counts matmul, bmm, convolution and attention FLOPs only,
  not elementwise work or normalisation, so it reads ``null`` where an arm
  has none of those (``adam_ema``) and is not comparable with XLA's
  ``cost_analysis``, which counts every operation;
* ``sol_ms`` and ``sol_share``: that count over the H100 SXM data sheet's
  dense peak for the arm's dtype (67 TFLOP/s fp32 outside the tensor cores,
  the port's fp32 runs with TF32 off; 989 TFLOP/s bf16).  The backbone arms
  take ``--dtype``; ``adam_ema`` and ``decode_metrics`` run in fp32 always.

On the CPU the device fields and the speed-of-light fields are null.

The JAX tool runs each arm as one ``lax.scan`` program whose carry takes the
arm's output at ~0 weight (``couple``), so that XLA neither hoists the body
out of the loop nor drops it as dead code.  Eager PyTorch does neither, so
the bodies here run as they are and need no coupling.  Nothing is captured
or compiled (no CUDA graphs, no ``torch.compile``): either would change the
program being attributed.

Usage:
  python -m dynaboa_tpu_torch.tools.profile_update_floor [--iters 64]
      [--dtype bfloat16] [--device cuda] [--use_pallas_lbs 1] [--out PATH]
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import tempfile
import time

import torch

from dynaboa_tpu_torch.tools.bench import build, card_info, make_frames, sync

FULL_STEPS = 12
PROFILE_ITERS = 3
# CUDA runtime calls by which the host waits for the device
HOST_SYNCS = ("cudaStreamSynchronize", "cudaEventSynchronize")
# H100 SXM data sheet, dense: fp32 outside the tensor cores, bf16
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
GRAD, FWDB, FWD1, ADAM, DM = ("grad(batched fwd+bwd)", "fwd_batched",
                              "fwd1(probe/teacher)", "adam_ema",
                              "decode_metrics")


def grad_body(engine, frame, state, bank):
    """One batched upper-level gradient at the live params, then
    ``p -= 1e-6 * g`` in place: the params stay the leaf tensors that
    ``state.optimizer`` holds."""
    params = list(state.params.values())

    def body():
        loss, _, _ = engine._level_loss(state.params, frame, bank,
                                        engine._upper, state.teacher_params,
                                        engine._history(state))
        g = torch.autograd.grad(loss, params)
        with torch.no_grad():
            torch._foreach_sub_(params, torch._foreach_mul(g, 1e-6))

    return body


def batched_rows(engine, frame, state, bank) -> torch.Tensor:
    """The gradient's batch: frame, history slot and exemplars (JAX
    ``tools/profile_update_floor.py:168-171``)."""
    slot = state.step % engine.cfg.interval
    return torch.cat([frame.image, state.hist_images[slot], bank.images])


def forward_body(engine, params, x):
    """A no-grad forward of ``x`` (the batched rows, or one frame)."""

    def body():
        with torch.no_grad():
            engine._forward(params, x)

    return body


def copy_state(state):
    """An independent copy of params, teacher and Adam moments."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in state.params.items()}
    opt = type(state.optimizer)(list(params.values()))
    opt.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
    return dataclasses.replace(
        state, params=params, optimizer=opt,
        teacher_params={k: v.clone() for k, v in state.teacher_params.items()})


def adam_ema_body(engine, state):
    """Adam + teacher EMA over the full tree with constant grads of 1e-6,
    on a copy of ``state``."""
    st = copy_state(state)
    grads = [torch.full_like(p, 1e-6) for p in st.params.values()]

    def body():
        engine._outer_update(grads, st)
        engine._ema_teacher(st)

    return body


def decode_metrics_body(engine, frame, state):
    """The no-grad SMPL decode of one forward's prediction and its metric
    record against the frame's GT targets."""
    from dynaboa_tpu_torch.metrics.eval import gt_targets

    with torch.no_grad():
        rotmat, shape, _, _ = engine._forward(state.params, frame.image)
        tgt = gt_targets(engine.smpls, frame.pose, frame.betas, frame.gender)

    def body():
        with torch.no_grad():
            _, verts = engine._decode(rotmat, shape, no_grad=True)
            engine._metrics(verts, tgt)

    return body


def count_flops(body) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        body()
    return fc.get_total_flops()


def device_profile(body, n: int, device, trace_path: str):
    """(device ms, kernels, idle share, host syncs) per iteration over
    ``n`` profiled iterations."""
    from dynaboa_tpu_torch.apps.profile import device_busy

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            body()
        sync(device)
    prof.export_chrome_trace(trace_path)
    kernels, busy, span = device_busy(trace_path)
    with open(trace_path) as f:
        syncs = sum(1 for e in json.load(f)["traceEvents"]
                    if e.get("name") in HOST_SYNCS)
    return busy / 1e3 / n, kernels / n, 1.0 - busy / span, syncs / n


def run_arm(label: str, body, args, device, dtype: str, trace_dir: str,
            results: dict) -> dict:
    """Warm-up, the timed loop, the FLOP count and (on a card) the profiled
    loop of one arm; its entry in ``results["arms"]``."""
    from dynaboa_tpu_torch.kernels import lbs as klbs

    launches0 = klbs.skin.launches
    body()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        body()
    sync(device)
    per_ms = (time.perf_counter() - t0) / args.iters * 1e3
    flops = count_flops(body) or None
    arm = {"ms_per_iter": per_ms,
           "gflop_per_iter": flops / 1e9 if flops else None,
           "device_ms_per_iter": None, "kernels_per_iter": None,
           "idle_share": None, "host_syncs_per_iter": None,
           "sol_ms": None, "sol_share": None}
    line = f"[{label}] {per_ms:.3f} ms/iter"
    if device.type == "cuda":
        name = "".join(c if c.isalnum() else "_" for c in label)
        dev_ms, kernels, idle, syncs = device_profile(
            body, PROFILE_ITERS, device,
            os.path.join(trace_dir, f"trace_{dtype}_{name}.json"))
        arm.update(device_ms_per_iter=dev_ms, kernels_per_iter=kernels,
                   idle_share=idle, host_syncs_per_iter=syncs)
        line += (f"; device {dev_ms:.3f} ms, {kernels:.0f} kernels, idle "
                 f"share {idle:.3f}, {syncs:g} host syncs")
        if flops:
            sol = flops / PEAK_FLOPS[dtype] * 1e3
            arm.update(sol_ms=sol, sol_share=sol / per_ms)
            line += (f"; {flops / 1e9:.2f} GFLOP/iter, {dtype} "
                     f"speed-of-light {sol:.3f} ms -> "
                     f"{100 * sol / per_ms:.1f}% util")
    elif flops:
        line += f"; {flops / 1e9:.2f} GFLOP/iter"
    arm["skin_kernel_launches"] = klbs.skin.launches - launches0
    print(line, flush=True)
    results["arms"][label] = arm
    return arm


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=64)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N or cpu)")
    p.add_argument("--use_pallas_lbs", type=int, default=1, choices=[0, 1],
                   help="Hopper skinning kernel for the no-grad decodes")
    p.add_argument("--tiny", type=int, default=0, choices=[0, 1],
                   help="smoke mode: tiny network and body model")
    p.add_argument("--trace_dir", default=None,
                   help="where the arms' chrome traces go (default: a "
                        "temporary directory, removed at the end)")
    p.add_argument("--out", default="")
    return p


def main(argv=None) -> dict:
    from dynaboa_tpu_torch.apps.common import require_device
    from dynaboa_tpu_torch.config import AdaptConfig

    args = build_parser().parse_args(argv)
    device = require_device(args.device)
    if args.iters < 1:
        raise SystemExit("--iters must be at least 1")
    cfg = AdaptConfig(record_lowerlevel=False, compute_dtype=args.dtype,
                      use_pallas_lbs=bool(args.use_pallas_lbs))
    system = build(cfg, device, args.tiny)
    eng = system.engine
    frame = make_frames(1, device)[0]

    # -- the worst-case per-update cost of the real step ---------------------
    state = eng.init_state(system.params)
    state, _ = eng.step(state, frame, cos_sim_threshold=-1.0)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(FULL_STEPS):
        state, _ = eng.step(state, frame, cos_sim_threshold=-1.0)
    sync(device)
    frame_ms = (time.perf_counter() - t0) / FULL_STEPS * 1e3
    n_upd = 1 + cfg.optim_steps
    print(f"[full-step] {frame_ms:.1f} ms/frame at {n_upd} updates "
          f"-> {frame_ms / n_upd:.2f} ms/update (forced gate)", flush=True)

    results = {"full_step_ms_per_frame": frame_ms,
               "updates_per_frame": n_upd,
               "full_step_ms_per_update": frame_ms / n_upd,
               "iters": args.iters, "dtype": args.dtype,
               "profile_iters": PROFILE_ITERS,
               "use_pallas_lbs": bool(args.use_pallas_lbs),
               **card_info(device), "arms": {}}

    with torch.no_grad():
        feats = eng._forward(state.params, frame.image)[3]
    bank = eng._retrieve(feats[5][0],
                         torch.Generator(device=device).manual_seed(0))
    x = batched_rows(eng, frame, state, bank)
    print(f"    (batched rows: {x.shape[0]})", flush=True)
    results["batched_rows"] = x.shape[0]

    with tempfile.TemporaryDirectory() as tmp:
        trace_dir = args.trace_dir or tmp
        os.makedirs(trace_dir, exist_ok=True)

        def arm(label, body, dtype=args.dtype):
            return run_arm(label, body, args, device, dtype, trace_dir,
                           results)

        grad = arm(GRAD, grad_body(eng, frame, state, bank))
        fwdb = arm(FWDB, forward_body(eng, state.params, x))
        fwd1 = arm(FWD1, forward_body(eng, state.params, frame.image))
        adam = arm(ADAM, adam_ema_body(eng, state), "float32")
        dm = arm(DM, decode_metrics_body(eng, frame, state), "float32")

    def total(key):
        if grad[key] is None:
            return None
        return grad[key] + 2 * fwd1[key] + adam[key] + dm[key]

    parts = total("ms_per_iter")
    print(f"\n[sum] grad {grad['ms_per_iter']:.2f} + 2xfwd1 "
          f"{2 * fwd1['ms_per_iter']:.2f} + adam_ema "
          f"{adam['ms_per_iter']:.2f} + decode_metrics "
          f"{dm['ms_per_iter']:.2f} = {parts:.2f} ms vs measured "
          f"{frame_ms / n_upd:.2f} ms/update", flush=True)
    bwd_ms = grad["ms_per_iter"] - fwdb["ms_per_iter"]
    print(f"[split] batched fwd {fwdb['ms_per_iter']:.2f} ms, backward+rest "
          f"of grad {bwd_ms:.2f} ms", flush=True)
    results["sum_ms"] = parts
    results["device_sum_ms"] = total("device_ms_per_iter")
    results["grad_minus_fwd_ms"] = bwd_ms
    if results["device_sum_ms"] is not None:
        print(f"[device-sum] {results['device_sum_ms']:.2f} ms of device "
              f"time per update against {parts:.2f} ms of wall", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
