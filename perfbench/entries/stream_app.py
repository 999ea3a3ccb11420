"""The window drives ``dynaboa_tpu_torch.apps.stream.run`` headless, closed
loop: the mix's frame pool (the ``clip`` source's ``{"bgr", "kp"}``
items, ``kp`` None where the detector finds nobody and the app passes the
frame through) is handed in by a generator, cycled, until the deadline, and
a sink takes each composited frame.  The app calls ``step`` with the
configuration's gate, so the mix sets no threshold and no caps.

Each ``run`` call starts adapting afresh from the seeded weights, so the
warm-up is a call of its own.  The check compares the window's first
``check.start_frames`` adapted frames from the seeded weights, and
``check.samples`` adapted frames from copies of the program's state just
before each, their overlays included.  The traced segment is a call of its
own over the pool's first ``trace.frames`` frames, whatever the window did.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from perfbench.harness import check, trace, traffic
from perfbench.harness.drive import PeakMemory, nonfinite, sync, thirds
from perfbench.harness.program import build_system, make_inputs, \
    reference_context
from perfbench.harness.replay import part, tf32

OVERLAY_COLOR = (205 / 255, 129 / 255, 98 / 255)


class _Watched:
    """The engine as the stream app sees it, with the benchmark's hooks
    around ``step``: the span for the trace, copies of the state around the
    compared frames and their outputs, the update counts and the
    non-finite flag."""

    def __init__(self, engine):
        self.engine = engine
        self.hist = None
        self.watch()

    def watch(self, keep=(), copy_after=(), bufs=()):
        self.i = 0
        self.keep, self.copy_after = set(keep), set(copy_after)
        self.bufs = list(bufs)
        self.before, self.after, self.outs = {}, {}, {}
        self.updates = []
        self.bad = None

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def step(self, state, frame, **kw):
        i = self.i
        if self.hist is None:
            self.hist = check.hist_like(state)
        if i in self.keep:
            self.before[i] = check.snapshot(state, self.bufs.pop())
        with torch.profiler.record_function(trace.STEP_SPAN):
            state, out = self.engine.step(state, frame, **kw)
        if i in self.keep or i in self.copy_after:
            self.after[i] = check.snapshot(state, self.bufs.pop())
            self.outs[i] = out
        b = nonfinite(out)
        self.bad = b if self.bad is None else (self.bad | b)
        self.updates.append(int(out["optim_steps"]) + 1)
        self.i += 1
        return state, out


def drive(run) -> dict:
    cfg, mix, dev, seed = run.cfg, run.mix, run.device, run.seed
    from dynaboa_tpu_torch.apps import stream

    parts = {"imports": time.perf_counter() - run.t_start}
    inp = make_inputs(cfg, seed, dev)
    sync(dev)
    parts["inputs"] = time.perf_counter() - run.t_start
    system = build_system(cfg, inp, dev, run.overrides)
    pool = traffic.frames(run)
    if all(item["kp"] is None for item in pool):
        raise ValueError("the frame pool has nobody in it")
    W, ck = mix["warmup_frames"], mix["check"]
    S0 = ck["start_frames"]
    n_lo = int(run.seconds * ck["min_fps"])
    samples = [S0 + p for p in traffic.sample_positions(
        seed, max(n_lo - S0, 1), ck["samples"])]
    if mix["updates"]["threshold"] is not None or mix["updates"]["caps"]:
        raise ValueError("the stream app takes the configuration's gate")
    watched = _Watched(system.engine)
    app = SimpleNamespace(engine=watched, device=system.device,
                          smpls=system.smpls, params=system.params)

    class Provider:
        kp = None

        def estimate(self, frame_bgr):
            return self.kp

    provider = Provider()

    def feed(start, stop_at=None, count=None, t_in=None):
        i = 0
        while (count is None or i < count) and \
                (stop_at is None or time.perf_counter() < stop_at):
            item = pool[(start + i) % len(pool)]
            provider.kp = None if item["kp"] is None else item["kp"][None]
            if t_in is not None:
                t_in.append(time.perf_counter())
            yield item["bgr"]
            i += 1

    # the window frame of each adapted frame (step call) the check needs
    frame_of, j = [], 0
    while len(frame_of) < max(samples + [S0 - 1]) + 1:
        if pool[(W + j) % len(pool)]["kp"] is not None:
            frame_of.append(j)
        j += 1
    keep_imgs = {frame_of[i] for i in set(samples) | set(range(S0))}

    sync(dev)
    parts["system"] = time.perf_counter() - run.t_start
    stream.run(app, feed(0, count=W), provider, lambda img: None,
               fused=mix["fused"])
    peak = PeakMemory(dev)
    peak.hold()
    bufs = [check.snapshot_buffer(system.params, watched.hist)
            for _ in range(2 * len(samples) + S0)]
    peak.held()
    watched.watch(keep=samples, copy_after=range(S0), bufs=bufs)
    sync(dev)

    t_in, t_out, kept = [], [], {}

    def sink(img):
        j = len(t_out)
        t_out.append(time.perf_counter())
        if j in keep_imgs:
            kept[j] = img

    t0 = time.perf_counter()
    setup_s = t0 - run.t_start
    summary = stream.run(app, feed(W, stop_at=t0 + run.seconds, t_in=t_in),
                         provider, sink, fused=mix["fused"])
    sync(dev)
    window_s = time.perf_counter() - t0
    n = len(t_in)
    lat = [b - a for a, b in zip(t_in, t_out)]
    parts["warmup"] = setup_s
    r = {"setup_s": setup_s, "window_s": window_s, "frames": n,
         "adapted": len(watched.updates), "setup_parts": parts,
         "records": len(t_out), "latencies_s": lat,
         "updates": list(watched.updates), "summary": summary,
         "thirds": thirds(t0, t_out, window_s)}
    failed = int(bool(watched.bad)) if watched.bad is not None else 0
    failed += n - len(t_out)
    before, after, outs = watched.before, watched.after, watched.outs

    if run.trace:
        tr = mix["trace"]
        watched.watch()

        def body():
            stream.run(app, feed(0, count=tr["frames"]), provider,
                       lambda img: None, fused=mix["fused"])
        r["trace"] = trace.profile(body, dev)
        r["trace"]["frames"] = tr["frames"]
    r["memory_peak_bytes"] = peak.read()
    r["failed"] = failed
    faces = system.smpls.neutral.faces
    del app, watched, system

    def ref_frame(i):
        j = frame_of[i]
        item = pool[(W + j) % len(pool)]
        return {"bgr": item["bgr"], "kp": item["kp"], "sink": kept.get(j)}

    start = [(ref_frame(i), outs[i]) for i in range(S0)
             if i in outs and frame_of[i] in kept]
    h, w = pool[0]["bgr"].shape[:2]
    r["check"] = {
        "inputs": inp, "faces": faces, "size": (w, h),
        "start_frames": start if len(start) == S0 else [],
        "start_after": after.get(S0 - 1) if len(start) == S0 else None,
        "samples": {s: (before[s], after[s], outs[s], ref_frame(s))
                    for s in samples if s in outs and frame_of[s] in kept},
    }
    return r


def _record(out, sink):
    rec = check.program_record(out)
    rec["overlay"] = sink
    return rec


def program_side(chk: dict) -> dict:
    side = {"samples": {}}
    if chk["start_after"] is not None:
        side["start"] = part([_record(o, fr["sink"])
                              for fr, o in chk["start_frames"]],
                             check.split(chk["start_after"]))
    for s, (_, after, out, fr) in chk["samples"].items():
        side["samples"][s] = part(_record(out, fr["sink"]),
                                  check.split(after))
    return side


def _frame(fr, device):
    """The reference's crop and keypoints of a frame, and its box."""
    from perfbench.reference import image as RI

    center, scale, bbox, kp = RI.bbox_from_keypoints(fr["kp"])
    j2d = np.zeros((49, 3), np.float32)
    j2d[:25] = RI.normalize_keypoints(kp, center, scale)
    rgb = torch.from_numpy(np.ascontiguousarray(fr["bgr"][:, :, ::-1])).to(
        device)
    return ({"image": RI.crop(rgb, center, scale)[None],
             "j2d": torch.from_numpy(j2d).to(device)[None]}, bbox)


def _overlay(chk, fr, rec, bbox):
    from perfbench.reference import image as RI

    w, h = chk["size"]
    verts, cam = rec["verts"][0], rec["cam"][0].cpu().numpy()
    if not (bool(torch.isfinite(verts).all()) and np.isfinite(cam).all()):
        return fr["bgr"]
    return RI.overlay(fr["bgr"], verts, chk["faces"],
                      RI.crop_cam_to_frame(cam, bbox, w, h), w, h,
                      OVERLAY_COLOR)


def reference_side(cfg: dict, chk: dict, device, control=False) -> dict:
    from perfbench.reference import step as RS

    ctx = reference_context(cfg, chk["inputs"], device)

    def one(st, fr):
        frame, bbox = _frame(fr, device)
        a = cfg["adapt"]
        rec = RS.step(ctx, st, frame, a["cos_sim_threshold"], a["optim_steps"])
        rec["overlay"] = _overlay(chk, fr, rec, bbox)
        return rec

    w = chk["inputs"].weights
    side = {"samples": {}}
    with tf32(control):
        if chk["start_frames"]:
            st = RS.fresh_state(ctx, w, cfg["model"]["img_res"], device)
            recs = [one(st, fr) for fr, _ in chk["start_frames"]]
            side["start"] = part(recs, (st.params, st.teacher, st.m, st.v),
                                 (w, w), recs[0]["grad_norms"])
        for s, (before, _, _, fr) in chk["samples"].items():
            st = check.ref_state(before, ctx, device)
            rec = one(st, fr)
            side["samples"][s] = part(rec, (st.params, st.teacher, st.m,
                                            st.v), check.split(before)[:2],
                                      rec["grad_norms"])
    return side
