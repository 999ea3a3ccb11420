"""The window drives ``BilevelEngine.step(state, frame, threshold, cap)``,
one call per frame, one stream, closed loop, over the mix's frame pool
(the ``crops`` source's dicts), with the mix's per-frame caps and gate
threshold.

The check compares the first ``check.start_frames`` warm-up frames from
the seeded weights, and ``check.samples`` window frames from copies of the
program's state just before each.  The traced segment runs
``trace.frames`` frames after the window from the pool's first frames at
the caps ``trace.caps``, whatever the seed and whatever the window did;
every run traces it, with ``--trace 0`` too, since its device time per
frame is an end-to-end metric.
"""

from __future__ import annotations

import time

import torch

from perfbench.harness import check, trace, traffic
from perfbench.harness.drive import PeakMemory, nonfinite, sync, thirds
from perfbench.harness.program import build_system, make_inputs, \
    reference_context
from perfbench.harness.replay import part, tf32


def _threshold(run):
    thr = run.mix["updates"]["threshold"]
    return run.cfg["adapt"]["cos_sim_threshold"] if thr is None else thr


def drive(run) -> dict:
    cfg, mix, dev, seed = run.cfg, run.mix, run.device, run.seed
    from dynaboa_tpu_torch.engine.bilevel import Frame

    parts = {"imports": time.perf_counter() - run.t_start}
    inp = make_inputs(cfg, seed, dev)
    sync(dev)
    parts["inputs"] = time.perf_counter() - run.t_start
    system = build_system(cfg, inp, dev, run.overrides)
    engine = system.engine
    pool = traffic.frames(run)
    frames = [Frame(**f) for f in pool]
    W, ck = mix["warmup_frames"], mix["check"]
    S0 = ck["start_frames"]
    assert 0 < S0 <= W
    n_lo = int(run.seconds * ck["min_fps"])
    caps = (traffic.caps(run, W + int(run.seconds * 1000))
            if mix["updates"]["caps"] else None)
    samples = traffic.sample_positions(
        seed, n_lo, ck["samples"], None if caps is None else caps[W:W + n_lo])
    thr = _threshold(run)

    def cap_at(g):
        return None if caps is None else int(caps[g % len(caps)])

    def frame_at(g):
        return frames[g % len(frames)], cap_at(g)

    sync(dev)
    parts["system"] = time.perf_counter() - run.t_start
    state = engine.init_state(system.params)
    peak = PeakMemory(dev)
    peak.hold()
    hist = check.hist_like(state)
    start_buf = check.snapshot_buffer(system.params, hist)
    bufs = [check.snapshot_buffer(system.params, hist)
            for _ in range(2 * len(samples))]
    peak.held()
    warm = []
    for g in range(W):
        f, c = frame_at(g)
        state, out = engine.step(state, f, cos_sim_threshold=thr, extra_cap=c)
        if g < S0:
            warm.append(out)
            if g == S0 - 1:
                start_after = check.snapshot(state, start_buf)
    sync(dev)
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    updates, done, before, after, outs = [], [], {}, {}, {}

    t0 = time.perf_counter()
    setup_s = t0 - run.t_start
    deadline = t0 + run.seconds
    i = 0
    while time.perf_counter() < deadline:
        f, c = frame_at(W + i)
        if i in samples:
            before[i] = check.snapshot(state, bufs.pop())
        state, out = engine.step(state, f, cos_sim_threshold=thr, extra_cap=c)
        if i in samples:
            after[i] = check.snapshot(state, bufs.pop())
            outs[i] = out
        bad = bad | nonfinite(out)
        updates.append(int(out["optim_steps"]) + 1)
        done.append(time.perf_counter())
        i += 1
    sync(dev)
    window_s = time.perf_counter() - t0
    n = i

    parts["warmup"] = setup_s
    r = {"setup_s": setup_s, "window_s": window_s, "frames": n,
         "adapted": n, "updates": updates, "setup_parts": parts,
         "thirds": thirds(t0, done, window_s)}
    # every run traces the segment: its device time is an end-to-end
    # metric (``device_ms_per_frame``), the rest per-layer ones
    tr = mix["trace"]
    tcaps = tr.get("caps") or [None]
    tupdates = []

    def body():
        nonlocal state
        for j in range(tr["frames"]):
            with torch.profiler.record_function(trace.STEP_SPAN):
                state, out = engine.step(state, frames[j % len(frames)],
                                         cos_sim_threshold=thr,
                                         extra_cap=tcaps[j % len(tcaps)])
            tupdates.append(out["optim_steps"])
    r["trace"] = trace.profile(body, dev)
    r["trace"]["frames"] = tr["frames"]
    r["trace"]["updates"] = [int(n) + 1 for n in tupdates]
    r["memory_peak_bytes"] = peak.read()
    r["failed"] = int(bool(bad))
    del state, engine, system

    def ref_frame(g):
        c = cap_at(g)
        return {"frame": pool[g % len(pool)],
                "cap": cfg["adapt"]["optim_steps"] if c is None else c}

    r["check"] = {
        "inputs": inp, "thr": thr, "warm": warm, "start_after": start_after,
        "start_frames": [ref_frame(g) for g in range(S0)],
        "samples": {s: (before[s], after[s], outs[s], ref_frame(W + s))
                    for s in samples if s in outs},
    }
    return r


def program_side(chk: dict) -> dict:
    rec = check.program_record
    side = {"start": part([rec(o) for o in chk["warm"]],
                          check.split(chk["start_after"])),
            "samples": {}}
    for s, (_, after, out, _) in chk["samples"].items():
        side["samples"][s] = part(rec(out), check.split(after))
    return side


def reference_side(cfg: dict, chk: dict, device, control=False) -> dict:
    from perfbench.reference import step as RS

    ctx = reference_context(cfg, chk["inputs"], device)
    w = chk["inputs"].weights
    side = {"samples": {}}
    with tf32(control):
        st = RS.fresh_state(ctx, w, cfg["model"]["img_res"], device)
        recs = [RS.step(ctx, st, fr["frame"], chk["thr"], fr["cap"])
                for fr in chk["start_frames"]]
        side["start"] = part(recs, (st.params, st.teacher, st.m, st.v),
                             (w, w), recs[0]["grad_norms"])
        for s, (before, _, _, fr) in chk["samples"].items():
            st = check.ref_state(before, ctx, device)
            rec = RS.step(ctx, st, fr["frame"], chk["thr"], fr["cap"])
            side["samples"][s] = part(rec, (st.params, st.teacher, st.m,
                                            st.v), check.split(before)[:2],
                                      rec["grad_norms"])
    return side
