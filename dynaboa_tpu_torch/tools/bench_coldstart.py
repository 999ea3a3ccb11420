#!/usr/bin/env python
"""Cold start of the port (counterpart of the root
``tools/bench_coldstart.py``): process start to the first adapted frame.

Runs ``--runs`` child processes.  Each imports the port, builds the bf16
flagship system of the benchmark (``tools/bench.py:build``; the skinning
kernel on) and adapts one frame; it reports ``build_s`` (imports and
build), ``first_step_s`` (state, step and the result on the host) and the
parent's ``process_wall_s``.  A child that compiled the skinning kernel
with nvcc (the first after a fresh checkout) reports its ``nvcc_s`` and is
reported apart, under ``with_kernel_build``.

Usage:
  python -m dynaboa_tpu_torch.tools.bench_coldstart [--runs 3] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import subprocess
import sys
import time

ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))

CHILD = r"""
import time
t0 = time.perf_counter()
import torch
from dynaboa_tpu_torch.config import AdaptConfig
from dynaboa_tpu_torch.kernels import lbs as klbs
from dynaboa_tpu_torch.tools.bench import build, make_frames, sync
s = build(AdaptConfig(record_lowerlevel=False, compute_dtype="bfloat16",
                      use_pallas_lbs=True), %(device)r, tiny=%(tiny)r)
sync(s.device)
t_build = time.perf_counter() - t0
frames = make_frames(1, s.device)
sync(s.device)
t1 = time.perf_counter()
state = s.engine.init_state(s.params)
state, out = s.engine.step(state, frames[0])
float(out["mpjpe"].sum())
t_first = time.perf_counter() - t1
built = klbs._built.get("lbs_skin")
print("CHILD", t_build, t_first, built.seconds if built else 0.0)
"""


def run_child(device: str, tiny: bool) -> dict:
    """One child process; its three times and the kernel's nvcc seconds."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", CHILD % {"device": device, "tiny": tiny}],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=900)
    wall = time.perf_counter() - t0
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("CHILD")]
    if out.returncode != 0 or not line:
        raise RuntimeError(f"cold-start child failed ({out.returncode}):\n"
                           f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    _, t_build, t_first, nvcc = line[0].split()
    return {"build_s": float(t_build), "first_step_s": float(t_first),
            "process_wall_s": wall, "nvcc_s": float(nvcc)}


def main(argv=None) -> dict:
    from dynaboa_tpu_torch.apps.common import require_device
    from dynaboa_tpu_torch.tools.bench import card_info

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N or cpu)")
    ap.add_argument("--tiny", type=int, default=0, choices=[0, 1],
                    help="smoke mode: tiny network and body model")
    args = ap.parse_args(argv)
    card = card_info(require_device(args.device))

    runs, with_build = [], None
    for i in range(args.runs):
        r = {"run": i, **run_child(args.device, bool(args.tiny))}
        print(r, file=sys.stderr, flush=True)
        if r["nvcc_s"] > 0.0:
            with_build = r
        else:
            runs.append(r)
    result = {"runs": runs, "with_kernel_build": with_build, **card}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
