"""The yardstick's pieces: traffic equal to the pieces of the port's tools
they were copied from, FLOP and byte counts against hand counts, and the
window arithmetic of the readers."""

from __future__ import annotations

import sys
import types

import numpy as np
import pytest
import torch

from perfbench.harness import cli, found, traffic, work
from perfbench.harness.inputs import hmr_shapes, hmr_weights
from perfbench.reference import hmr as ref_hmr

FULL = {"layers": [3, 4, 6, 3], "width": 64, "regressor_dim": 1024,
        "n_iter": 3, "img_res": 224}


BLOCKS = found.module("schedules", "geometric_blocks", cli.ROOT)
CLIP = found.module("sources", "clip", cli.ROOT)
CROPS = found.module("sources", "crops", cli.ROOT)
SPEC = {"dist": "geometric_blocks", "p": 0.25, "max": 7, "block": 16}


def _realistic_caps(n_frames: int) -> np.ndarray:
    """The extra-update caps ``tools/bench.py:measure_realistic`` hands the
    engine at mean 3 (p = 1/4), read off a stand-in engine."""
    from dynaboa_tpu_torch.tools import bench

    seen = []

    class Engine:
        device = torch.device("cpu")
        cfg = types.SimpleNamespace(optim_steps=7)

        def init_state(self, params):
            return None

        def step(self, state, frame, cos_sim_threshold=None, extra_cap=None):
            seen.append(extra_cap)
            return state, {"optim_steps": extra_cap}

    system = types.SimpleNamespace(engine=Engine(), params=None)
    bench.measure_realistic(system, [None], "t", means=(3,),
                            n_frames=n_frames)
    return np.asarray(seen[1:])


def test_cap_blocks_hold_the_realistic_distribution():
    """Each block's count of every cap is 16 times its share among the
    caps that ``measure_realistic`` draws at mean 3, rounded (to within
    0.1 for the sampling of 40,000 draws); the means agree to within 0.05;
    and a schedule holds the block's shares exactly."""
    drawn = _realistic_caps(40_000)
    block = BLOCKS.block(0.25, 7, 16)
    shares = np.bincount(drawn, minlength=8) / len(drawn)
    assert np.abs(shares * 16 - np.bincount(block, minlength=8)).max() < 0.6
    assert abs(drawn.mean() - block.mean()) < 0.05
    caps = BLOCKS.caps(SPEC, 20251017, 4000)
    assert abs(np.bincount(caps, minlength=8) / 4000
               - np.bincount(block, minlength=8) / 16).max() == 0


@pytest.mark.parametrize("seed", [0, 987654321])
def test_clip_equals_make_clip(monkeypatch, seed):
    """The ``clip`` source gives ``tools/bench_stream_app.py:make_clip``'s
    frames and keypoints at 640x480 for the same seed, kept in memory."""
    from dynaboa_tpu_torch.tools import bench_stream_app

    written = []

    class Writer:
        def __init__(self, *a):
            pass

        def isOpened(self):
            return True

        def write(self, f):
            written.append(f.copy())

        def release(self):
            pass

    fake = types.SimpleNamespace(VideoWriter=Writer,
                                 VideoWriter_fourcc=lambda *a: 0)
    monkeypatch.setitem(sys.modules, "cv2", fake)
    kps = bench_stream_app.make_clip("unused.mp4", 5, 640, 480, seed=seed)
    frames, ours = CLIP.frames_and_keypoints(seed, 5, 640, 480, 1.5, 0.9)
    np.testing.assert_array_equal(ours, kps)
    for a, b in zip(frames, written):
        np.testing.assert_array_equal(a, b)


def test_cap_blocks_hold_the_same_work():
    """Every block of 16 frames holds caps 0-7 four, three, two, two, one,
    one, one and two times, as 8 pairs of the i-th smallest and i-th largest
    cap, in an order that the seed draws."""
    a, b = BLOCKS.caps(SPEC, 1, 64), BLOCKS.caps(SPEC, 2, 64)
    want = np.array([4, 3, 2, 2, 1, 1, 1, 2])
    for x in (a, b):
        for i in range(0, 64, 16):
            assert (np.bincount(x[i:i + 16], minlength=8) == want).all()
        pair_sums = sorted((x[0::2] + x[1::2])[:8])
        assert pair_sums == [4, 4, 4, 5, 5, 6, 7, 7]
    assert not np.array_equal(a, b)
    assert a.mean() == 2.625


def test_crops_are_seeded_and_distinct():
    cfg = {"model": {"img_res": 32}}
    a = CROPS.make(3, {"pool": 4}, cfg, "cpu")
    b = CROPS.make(3, {"pool": 4}, cfg, "cpu")
    c = CROPS.make(4, {"pool": 4}, cfg, "cpu")
    assert torch.equal(a[2]["image"], b[2]["image"])
    assert not torch.equal(a[2]["image"], c[2]["image"])
    assert not torch.equal(a[0]["image"], a[1]["image"])


def test_sample_positions_hold_the_longest_frame():
    caps = BLOCKS.caps(SPEC, 11, 40)
    pos = traffic.sample_positions(11, 40, 3, caps)
    assert len(pos) == 3 and len(set(pos)) == 3
    assert int(np.argmax(caps)) in pos


def test_skin_bytes_hand_count():
    """chip_smoke.py phase 2's count: 17,943,924 B at N = 1 and 19,117,992
    at N = 8 for V = 6890."""
    assert work.skin_bytes(1, 6890) == 17_943_924
    assert work.skin_bytes(8, 6890) == 19_117_992
    assert work.skin_least_seconds(1, 6890) == pytest.approx(5.3564e-6,
                                                             rel=1e-4)


def test_hmr_flops_hand_count():
    """ResNet-50 at 224: 4,087,136,256 multiply-adds in its convolutions
    (torchvision's 4.09 G less the classifier); the regressor 3 x
    (2205 x 1024 + 1024 x 1024 + 1024 x 157) = 10,401,792."""
    assert work.hmr_forward_flops(FULL) == 2 * (4_087_136_256 + 10_401_792)


def test_hmr_flops_match_flop_counter():
    """At a small size, the count equals torch's FlopCounterMode over the
    reference forward (convolutions and matmuls)."""
    from torch.utils.flop_counter import FlopCounterMode

    model = {"layers": [1, 2, 1, 1], "width": 8, "regressor_dim": 32,
             "n_iter": 3, "img_res": 64}
    w = hmr_weights(model, 1, "cpu")
    init = (torch.zeros(1, 144), torch.zeros(1, 10), torch.zeros(1, 3))
    with FlopCounterMode(display=False) as fc:
        ref_hmr.forward(w, torch.zeros(1, 64, 64, 3), model["layers"], 3,
                        *init)
    assert fc.get_total_flops() == work.hmr_forward_flops(model)


def test_rows_per_frame():
    """pw3d: 8 + 11 n forward rows a frame; webcam: 4 + 8 n."""
    import json
    import os

    cfgs = {n: json.load(open(os.path.join(cli.PB, "configs", f"{n}.json")))
            for n in ("dynaboa_3dpw", "dynaboa_webcam")}
    for n in range(1, 9):
        assert work.rows_per_frame(cfgs["dynaboa_3dpw"]["adapt"], n) == \
            8 + 11 * n
        assert work.rows_per_frame(cfgs["dynaboa_webcam"]["adapt"], n) == \
            4 + 8 * n


def test_weights_cover_the_port_model():
    """The seeded weights have every parameter of the port's HMR, shape
    for shape."""
    from dynaboa_tpu_torch.models.hmr import HMR

    model = {"layers": [1, 1, 2, 1], "width": 8, "regressor_dim": 16,
             "n_iter": 3, "img_res": 32}
    port = dict(HMR(layers=(1, 1, 2, 1), width=8,
                    regressor_dim=16).named_parameters())
    ours = {n: s for n, s, _ in hmr_shapes(model)}
    assert {k: tuple(v.shape) for k, v in port.items()} == ours


def test_window_readers():
    r = {"frames": 120, "adapted": 120, "window_s": 30.5, "latencies_s": list(
        np.linspace(0.1, 0.3, 201)), "setup_s": 9.0,
        "updates": [1] * 10}
    read = cli.reader
    assert read("adapted_fps")(r, None) == 120 / 30.5
    assert read("frame_latency_ms_p95")(r, None) == pytest.approx(290.0)
    assert read("setup_s")(r, None) == 9.0
    cfg = {"model": FULL, "adapt": {
        "sample_num": 1, "use_temporal_losses_lower": False,
        "use_temporal_losses_upper": True, "use_motion": True,
        "lower_level_mixtrain": False, "upper_level_mixtrain": False,
        "use_meanteacher": True, "inner_step": 1,
        "record_lowerlevel": False}}
    mfu = read("step.mfu")(r, cfg)
    assert mfu == pytest.approx(100 * 10 * 12 * work.hmr_forward_flops(FULL)
                                / (30.5 * 67e12))


def test_segment_readers():
    """The traced segment's device time per frame, the whole step's share
    of the peak over it, and the twins that read as the originals do; none
    of them reads where the device did nothing."""
    t = {"busy_s": 0.75, "window_s": 5.5, "frames": 8, "step_calls": 8,
         "updates": [1] * 8, "n_kernels": 8000, "host_syncs": 80,
         "kernels": {}}
    r = {"trace": t, "adapted": 120, "window_s": 30.5}
    read = cli.reader
    assert read("device_ms_per_frame")(r, None) == pytest.approx(93.75)
    assert read("engine.adapted_fps")(r, None) == 120 / 30.5
    cfg = {"model": FULL, "adapt": {
        "sample_num": 1, "use_temporal_losses_lower": False,
        "use_temporal_losses_upper": True, "use_motion": True,
        "lower_level_mixtrain": False, "upper_level_mixtrain": False,
        "use_meanteacher": True, "inner_step": 1,
        "record_lowerlevel": False}}
    assert read("step.mfu.engine")(r, cfg) == pytest.approx(
        100 * 8 * 12 * work.hmr_forward_flops(FULL) / (0.75 * 67e12))
    for name in ("model.launches", "step.host_syncs", "device.idle_share"):
        assert read(name + ".engine")(r, None) == read(name)(r, None)
    idle = {"trace": dict(t, busy_s=0.0)}
    assert read("device_ms_per_frame")(idle, None) is None
    assert read("step.mfu.engine")(idle, cfg) is None
