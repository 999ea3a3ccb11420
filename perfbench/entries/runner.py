"""The window drives ``StreamRunner.run`` (``engine/runner.py``, the path of
``run_on_3dpw.sh``) over the mix's pool of 3DPW-schema items (the
``pw3d_items`` source), cycled until the deadline: one stream, closed
loop, the configuration's gate (the mix sets no threshold and no caps),
the mix's ``runner`` settings (``chunk_size``, ``checkpoint_every``), the
per-frame records, scalars (JSONL) and result files written to a
directory under ``TMPDIR``.

The runner sees the engine through a wrapper that times each
``run_chunk`` call to its end on the device (a synchronize after it, where
the runner's ``_to_host`` waits anyway), which gives ``runner.host_ms``,
the window's time outside ``run_chunk`` per frame; the wrapper also wraps
each step in the harness's span, copies the state around the compared
frames and counts the updates.

The warm-up is a ``run`` call of its own over ``warmup_frames`` items; the
window's call goes on from its state, and so does the traced segment, a
``run`` call over the pool's first ``trace.frames`` items after the
window.  The check compares the warm-up's first ``check.start_frames``
frames from the seeded weights and ``check.samples`` window frames from
copies of the state; the reference crops each compared item's frame
itself.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import sys
import tempfile
import time

import torch

from perfbench.harness import check, found, trace, traffic
from perfbench.harness.drive import PeakMemory, nonfinite, sync, thirds
from perfbench.harness.program import build_system, make_inputs, \
    reference_context
from perfbench.harness.replay import part, tf32

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
program_side = found.module("entries", "engine_step", ROOT).program_side


class _Watched:
    """The engine as the runner sees it, with the benchmark's hooks around
    ``run_chunk``: the time to its end on the device, the span for the
    trace, copies of the state around the compared frames and their
    outputs, the update counts and the non-finite flag."""

    def __init__(self, engine, device):
        self.engine, self.device = engine, device
        self.watch()

    def watch(self, keep=(), copy_after=(), record=(), bufs=()):
        self.i = 0
        self.keep, self.copy_after = set(keep), set(copy_after)
        self.record = set(record) | self.keep | self.copy_after
        self.bufs = list(bufs)
        self.before, self.after, self.outs = {}, {}, {}
        self.updates, self.done = [], []
        self.chunk_s = 0.0
        self.bad = None

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def run_chunk(self, state, frames, cos_sim_threshold=None,
                  extra_cap=None):
        t0 = time.perf_counter()
        outs = []
        for frame in frames:
            i = self.i
            if i in self.keep:
                self.before[i] = check.snapshot(state, self.bufs.pop())
            with torch.profiler.record_function(trace.STEP_SPAN):
                state, out = self.engine.step(state, frame, cos_sim_threshold,
                                              extra_cap)
            if i in self.keep or i in self.copy_after:
                self.after[i] = check.snapshot(state, self.bufs.pop())
            if i in self.record:
                self.outs[i] = out
            b = nonfinite(out)
            self.bad = b if self.bad is None else (self.bad | b)
            self.updates.append(int(out["optim_steps"]) + 1)
            outs.append(out)
            self.i += 1
        sync(self.device)
        t1 = time.perf_counter()
        self.chunk_s += t1 - t0
        self.done += [t1] * len(frames)
        return state, outs


class _Cycled:
    """The pool's items in turn from ``start``: ``count`` of them, or until
    the host clock passes ``stop_at``."""

    def __init__(self, pool, start, count=None, stop_at=None):
        self.pool, self.start = pool, start
        self.count, self.stop_at = count, stop_at

    def __len__(self):
        return self.count or len(self.pool)

    def __iter__(self):
        i = 0
        while (self.count is None or i < self.count) and \
                (self.stop_at is None or time.perf_counter() < self.stop_at):
            yield self.pool[(self.start + i) % len(self.pool)]
            i += 1


def drive(run) -> dict:
    cfg, mix, dev, seed = run.cfg, run.mix, run.device, run.seed
    from dynaboa_tpu_torch.engine.runner import StreamRunner

    if mix["updates"]["threshold"] is not None or mix["updates"]["caps"]:
        raise ValueError("the runner takes the configuration's gate")
    parts = {"imports": time.perf_counter() - run.t_start}
    inp = make_inputs(cfg, seed, dev)
    sync(dev)
    parts["inputs"] = time.perf_counter() - run.t_start
    system = build_system(cfg, inp, dev, run.overrides)
    watched = _Watched(system.engine, dev)
    pool = traffic.frames(run)
    W, ck, rs = mix["warmup_frames"], mix["check"], mix["runner"]
    S0 = ck["start_frames"]
    assert 0 < S0 <= W
    samples = traffic.sample_positions(seed, int(run.seconds * ck["min_fps"]),
                                       ck["samples"])
    logs = tempfile.mkdtemp(prefix="runner_gate_")

    def go(state, name, stream):
        """One ``run`` call of a runner of its own, its records under
        ``logs/name``; the runner's prints go to standard error."""
        runner = StreamRunner(watched, os.path.join(logs, name),
                              checkpoint_every=rs["checkpoint_every"])
        try:
            with contextlib.redirect_stdout(sys.stderr):
                return runner.run(stream, state, chunk_size=rs["chunk_size"])
        finally:
            runner.close()

    try:
        sync(dev)
        parts["system"] = time.perf_counter() - run.t_start
        state = system.engine.init_state(system.params)
        peak = PeakMemory(dev)
        peak.hold()
        hist = check.hist_like(state)
        bufs = [check.snapshot_buffer(system.params, hist)
                for _ in range(2 * len(samples) + 1)]
        peak.held()
        watched.watch(copy_after=[S0 - 1], record=range(S0),
                      bufs=[bufs.pop()])
        state, _ = go(state, "warmup", _Cycled(pool, 0, count=W))
        warm = [watched.outs[i] for i in range(S0)]
        start_after = watched.after[S0 - 1]
        watched.watch(keep=samples, bufs=bufs)
        sync(dev)

        t0 = time.perf_counter()
        setup_s = t0 - run.t_start
        state, summary = go(state, "window",
                            _Cycled(pool, W, stop_at=t0 + run.seconds))
        sync(dev)
        window_s = time.perf_counter() - t0
        n = summary["frames"]
        parts["warmup"] = setup_s
        r = {"setup_s": setup_s, "window_s": window_s, "frames": n,
             "adapted": n, "updates": list(watched.updates),
             "chunk_s": watched.chunk_s, "setup_parts": parts,
             "thirds": thirds(t0, watched.done, window_s)}
        failed = int(bool(watched.bad)) if watched.bad is not None else 0
        failed += n - len(watched.updates)
        before, after, outs = watched.before, watched.after, watched.outs

        tr = mix["trace"]
        watched.watch()

        def body():
            nonlocal state
            state, _ = go(state, "trace", _Cycled(pool, 0, count=tr["frames"]))
        r["trace"] = trace.profile(body, dev)
        r["trace"]["frames"] = tr["frames"]
        r["trace"]["updates"] = list(watched.updates)
    finally:
        shutil.rmtree(logs, ignore_errors=True)
    r["memory_peak_bytes"] = peak.read()
    r["failed"] = failed
    del state, watched, system

    def ref_frame(g):
        return {"item": pool[g % len(pool)], "cap": cfg["adapt"]["optim_steps"]}

    r["check"] = {
        "inputs": inp, "thr": cfg["adapt"]["cos_sim_threshold"], "warm": warm,
        "start_after": start_after,
        "start_frames": [ref_frame(g) for g in range(S0)],
        "samples": {s: (before[s], after[s], outs[s], ref_frame(W + s))
                    for s in samples if s in outs},
    }
    return r


def _frame(item: dict, res: int, device) -> dict:
    """The reference's frame of a stream item: its own crop of the raw
    frame, the keypoints, pose, shape and gender, batch of one."""
    from perfbench.reference import image as RI

    def t(a):
        return torch.as_tensor(a).to(device)[None]

    return {"image": t(RI.crop(torch.from_numpy(item["frame_rgb"]),
                               item["center"], float(item["scale"]), res)),
            "j2d": t(item["smpl_j2d"]), "pose": t(item["pose"]),
            "betas": t(item["betas"]),
            "gender": torch.tensor([int(item["gender"])], device=device)}


def reference_side(cfg: dict, chk: dict, device, control=False) -> dict:
    from perfbench.reference import step as RS

    ctx = reference_context(cfg, chk["inputs"], device)
    res = cfg["model"]["img_res"]
    w = chk["inputs"].weights
    side = {"samples": {}}
    with tf32(control):
        st = RS.fresh_state(ctx, w, res, device)
        recs = [RS.step(ctx, st, _frame(fr["item"], res, device), chk["thr"],
                        fr["cap"]) for fr in chk["start_frames"]]
        side["start"] = part(recs, (st.params, st.teacher, st.m, st.v),
                             (w, w), recs[0]["grad_norms"])
        for s, (before, _, _, fr) in chk["samples"].items():
            st = check.ref_state(before, ctx, device)
            rec = RS.step(ctx, st, _frame(fr["item"], res, device),
                          chk["thr"], fr["cap"])
            side["samples"][s] = part(rec, (st.params, st.teacher, st.m,
                                            st.v), check.split(before)[:2],
                                      rec["grad_norms"])
    return side
