"""The CUDA graphs of ``BilevelEngine``'s gradient evaluations on a card,
for both benchmark configurations (``perfbench/configs/*.json``) at full
width over 12 frames, against the same engine run eagerly.

These tests need a CUDA card and skip without one.  The file imports no jax
(the card's machine has none), so on the card it runs without the suite's
conftest:

  python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_graphs_cuda.py
"""

import gc
import json
import math
import os

import pytest
import torch

from dynaboa_tpu_torch.apps.common import build_system
from dynaboa_tpu_torch.config import AdaptConfig, Paths
from dynaboa_tpu_torch.engine.bilevel import BilevelEngine, Frame

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("dynaboa_3dpw", "dynaboa_webcam")
N_FRAMES = 12
# the per-frame caps of pw3d's traced segment, at threshold -1: every kind
# of evaluation by frame 2, up to eight updates a frame
CAPS = (0, 7, 0, 6, 1, 3, 1, 3)
WARM_FRAMES = 3
# a graphed step against the eager step from the same state, worst over
# the 12 frames: relative gaps of the losses and their terms, of the
# vertices (over their largest magnitude) and of Adam's moments (tree
# norms).  Both run the same kernels and differ as two eager steps do: on
# an H100 graphed against eager read up to 3.3e-5, 2.3e-4 and 6.0e-4, two
# eager engines 3.8e-5, 1.5e-4 and 2.5e-4 (Adam scales near-zero gradients
# to full steps)
TOL = {"loss": 2e-4, "verts": 1e-3, "adam": 2e-3}
# memory a round of fresh states may add: a cuBLAS workspace made again
# after a capture drops them, and the allocator's caching and rounding
SLACK_BYTES = 64 << 20


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _config(name, **kw) -> tuple[AdaptConfig, bool]:
    with open(os.path.join(ROOT, "perfbench", "configs", f"{name}.json")) as f:
        spec = json.load(f)
    return AdaptConfig(**dict(spec["adapt"], **kw)), spec["compute_metrics"]


def _frames(n, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(n):
        xy = torch.rand((1, 49, 2), generator=g, device=device) * 2 - 1
        out.append(Frame(
            image=torch.randn((1, 224, 224, 3), generator=g, device=device),
            j2d=torch.cat([xy, torch.ones((1, 49, 1), device=device)], -1),
            pose=torch.zeros((1, 72), device=device),
            betas=torch.zeros((1, 10), device=device),
            gender=torch.zeros((1,), dtype=torch.int32, device=device)))
    return out


def _host(out: dict) -> dict:
    """The outputs as host tensors, flattened, copied when the step
    returns (not later)."""
    flat = {}
    for k, v in out.items():
        if isinstance(v, dict):
            flat.update({f"{k}/{kk}": vv.detach().cpu().clone()
                         for kk, vv in v.items()})
        elif isinstance(v, torch.Tensor):
            flat[k] = v.detach().cpu().clone()
        else:
            flat[k] = v
    return flat


def _copy_state(dst, src) -> None:
    """``dst`` takes ``src``'s weights, teacher, Adam state, history ring,
    counter and generator, in place."""
    with torch.no_grad():
        for k in src.params:
            dst.params[k].copy_(src.params[k])
            dst.teacher_params[k].copy_(src.teacher_params[k])
        dst.hist_images.copy_(src.hist_images)
        dst.hist_j2d.copy_(src.hist_j2d)
        if src.hist_box is not None:
            dst.hist_box.copy_(src.hist_box)
    dst.optimizer.state.clear()
    for pd, ps in zip(dst.params.values(), src.params.values()):
        if ps in src.optimizer.state:
            dst.optimizer.state[pd] = {
                k: v.clone() for k, v in src.optimizer.state[ps].items()}
    dst.step = src.step
    dst.rng.set_state(src.rng.get_state())


def _moments(state):
    return [torch.cat([state.optimizer.state[p][k].reshape(-1)
                       for p in state.params.values()])
            for k in ("exp_avg", "exp_avg_sq")]


def _gap(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp(min=1e-30))


def _gaps(oa, ob, sa, sb) -> dict:
    """One step's gaps of ``a`` from ``b``: the losses and their terms, the
    vertices and Adam's two moments, each relative to ``b``'s."""
    assert oa["optim_steps"] == ob["optim_steps"]
    n = int(ob["optim_steps"]) + 1
    terms = sorted(k for k in ob if k.startswith(("lower/", "upper/")))
    assert terms == sorted(k for k in oa if k.startswith(("lower/",
                                                          "upper/")))
    loss = max(_gap(oa["per_step_loss"][:n], ob["per_step_loss"][:n]),
               *(_gap(oa[k], ob[k]) for k in terms))
    adam = max(float(torch.linalg.vector_norm(x.double() - y.double())
                     / torch.linalg.vector_norm(y.double()))
               for x, y in zip(_moments(sa), _moments(sb)))
    return {"loss": loss, "verts": _gap(oa["verts"], ob["verts"]),
            "adam": adam}


def run_pair(engine_a, engine_b, params, frames, keep_at=None):
    """``engine_a`` adapts over ``frames`` from ``params``; before each
    frame ``engine_b``'s state takes a copy of ``a``'s, and both step.
    Returns ``a``'s outputs and graph counters per frame and the worst
    one-step gaps of ``a`` from ``b``."""
    sa, sb = engine_a.init_state(params), engine_b.init_state(params)
    outs, stats, kept = [], [], None
    worst = dict.fromkeys(("loss", "verts", "adam"), 0.0)
    for i, fr in enumerate(frames):
        _copy_state(sb, sa)
        kw = dict(cos_sim_threshold=-1.0, extra_cap=CAPS[i % len(CAPS)])
        sa, oa = engine_a.step(sa, fr, **kw)
        sb, ob = engine_b.step(sb, fr, **kw)
        outs.append(_host(oa))
        stats.append(dict(engine_a.graph_stats))
        for k, v in _gaps(outs[-1], _host(ob), sa, sb).items():
            worst[k] = max(worst[k], v)
        if i == keep_at:
            kept = oa
        if keep_at is not None and i == keep_at + 2:
            # frame t's outputs, as the depth-2 pipeline reads them now
            outs[keep_at]["after_two"] = _host(kept)
    return dict(outs=outs, stats=stats, gaps=worst,
                keys=len(sa.graphs._graphs), b_stats=engine_b.graph_stats)


def eager_twin(system, cfg, metrics) -> BilevelEngine:
    """An engine over the system's model, prior, bodies and store that
    runs every gradient evaluation eagerly."""
    eager = BilevelEngine(cfg, system.model, system.engine.prior,
                          system.smpls, system.store, compute_metrics=metrics)
    eager._graphed = False
    return eager


@pytest.fixture(scope="module", params=CONFIGS)
def runs(request, cuda_device):
    """The configuration's system adapting over 12 frames through its
    graphs, against the same engine run eagerly from a copy of its state
    at each frame."""
    cfg, metrics = _config(request.param)
    system = build_system(cfg, Paths(), cuda_device, compute_metrics=metrics)
    frames = _frames(N_FRAMES, cuda_device)
    graphed = run_pair(system.engine, eager_twin(system, cfg, metrics),
                       system.params, frames, keep_at=5)
    return dict(name=request.param, system=system, graphed=graphed)


@pytest.mark.cuda
def test_graphed_steps_equal_eager(runs):
    """Losses and their terms, predictions, Adam's moments and the number
    of updates of each graphed step against the eager step from the same
    state, to ``TOL``."""
    gaps = runs["graphed"]["gaps"]
    print(f"\n{runs['name']}: graphed against eager {gaps}")
    assert all(math.isfinite(v) and v <= TOL[k] for k, v in gaps.items()), \
        gaps


@pytest.mark.cuda
def test_record_of_frame_t_unchanged_after_frame_t_plus_2(runs):
    out = runs["graphed"]["outs"][5]
    later = out["after_two"]
    for k, v in later.items():
        a = out[k]
        assert (torch.equal(a, v) if isinstance(v, torch.Tensor)
                else a == v), k


@pytest.mark.cuda
def test_no_capture_after_the_warm_up(runs):
    """Every kind of evaluation is captured by frame 2; after it every
    evaluation replays."""
    g = runs["graphed"]
    stats = g["stats"]
    warm = stats[WARM_FRAMES - 1]
    assert warm["eager"] == warm["captures"] == g["keys"] > 0
    last = stats[-1]
    assert last["eager"] == warm["eager"]
    assert last["captures"] == warm["captures"]
    evaluations = sum(1 + int(o["optim_steps"]) + 1
                      for o in g["outs"][WARM_FRAMES:])
    assert last["replays"] - warm["replays"] == evaluations
    assert g["b_stats"]["captures"] == g["b_stats"]["replays"] == 0


@pytest.mark.cuda
def test_second_state_captures_at_once(runs):
    """A state on an engine that has warmed a key captures it on its first
    call, and its graphs are its own."""
    system = runs["system"]
    engine = system.engine
    before = dict(engine.graph_stats)
    state = engine.init_state(system.params)
    frames = _frames(2, system.device, seed=1)
    for fr, cap in zip(frames, (1, 1)):
        state, _ = engine.step(state, fr, cos_sim_threshold=-1.0,
                               extra_cap=cap)
    assert engine.graph_stats["eager"] == before["eager"]
    assert engine.graph_stats["captures"] - before["captures"] == \
        len(state.graphs._graphs) == runs["graphed"]["keys"]


@pytest.mark.cuda
def test_dropped_states_give_their_graphs_memory_back(runs):
    """A state dropped after its captures leaves no memory behind: over
    rounds of a fresh state stepping two frames, the card's allocated and
    reserved memory stay where the first round left them.  A graph pool
    that something outside the state keeps (a cuBLAS workspace made inside
    the capture), or that the allocator keeps cached, grows them by about a
    pool, 1.2 GiB, a state; the next capture could not reclaim it."""
    system = runs["system"]
    engine = system.engine
    frames = _frames(2, system.device, seed=2)
    readings = []
    for _ in range(4):
        state = engine.init_state(system.params)
        for fr in frames:
            state, out = engine.step(state, fr, cos_sim_threshold=-1.0,
                                     extra_cap=1)
        assert state.graphs._graphs
        del state, out
        gc.collect()
        torch.cuda.synchronize()
        readings.append((torch.cuda.memory_allocated(),
                         torch.cuda.memory_reserved()))
    print(f"\n{runs['name']}: allocated, reserved a round (MiB) "
          f"{[(a >> 20, r >> 20) for a, r in readings]}")
    first = readings[0]
    for allocated, reserved in readings[1:]:
        assert allocated <= first[0] + SLACK_BYTES
        assert reserved <= first[1] + SLACK_BYTES


@pytest.mark.cuda
def test_bfloat16_is_counted_as_eager(cuda_device):
    cfg, metrics = _config("dynaboa_webcam", compute_dtype="bfloat16")
    system = build_system(cfg, Paths(), cuda_device, compute_metrics=metrics)
    state = system.engine.init_state(system.params)
    for fr in _frames(3, cuda_device):
        state, _ = system.engine.step(state, fr, cos_sim_threshold=-1.0,
                                      extra_cap=1)
    stats = system.engine.graph_stats
    assert stats["eager"] == 3 * 3
    assert stats["captures"] == stats["replays"] == 0
    assert not state.graphs._graphs
