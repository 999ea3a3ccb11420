"""The graph path of ``BilevelEngine``'s gradient evaluations
(``dynaboa_tpu_torch/engine/graphs.py``) on the CPU, at the tiny size.

The CPU takes the eager path.  The graph path's bookkeeping (keys, the
warm-up, the buffers an evaluation reads, the binding to the weights'
storage, outputs copied out or left to the next replay) is run here with a
stand-in for the CUDA graph that records by running the evaluation and
replays by running it again on its buffers, writing into the same output
tensors as a replay does: it must give the eager path's numbers bit for
bit.  The constants the graph path needs on the device (``ops/device_const``)
must give the uncached code's outputs bit for bit.  The real graphs run in
``tests/test_torch_graphs_cuda.py`` on a card.
"""

import pytest
import torch

from dynaboa_tpu_torch import constants
from dynaboa_tpu_torch.config import AdaptConfig
from dynaboa_tpu_torch.engine import bilevel as teng
from dynaboa_tpu_torch.engine import graphs
from dynaboa_tpu_torch.losses import priors
from dynaboa_tpu_torch.models import smpl as tsmpl
from dynaboa_tpu_torch.models.hmr import HMR, init_weights_
from dynaboa_tpu_torch.ops import camera
from dynaboa_tpu_torch.ops.device_const import device_const
from tests import torch_port_fixtures as F

CONFIGS = {
    "retrieval_motion": AdaptConfig(interval=2, optim_steps=3),
    "fast_inner2": AdaptConfig(interval=2, optim_steps=2, inner_step=2,
                               fast_extra_updates=True),
    "no_boa": AdaptConfig(interval=2, use_boa=False),
    "window2": AdaptConfig(interval=2, optim_steps=2),
}


# -- the device constants against the code they replace ----------------------

def _chain_uncached(rot_mats, joints, parents):
    """``_rigid_transform_chain`` as it was, with Python-list indexing and a
    freshly built homogeneous row."""
    N, K = rot_mats.shape[0], rot_mats.shape[1]
    rel_joints = joints - torch.cat(
        [torch.zeros_like(joints[:, :1]), joints[:, list(parents[1:])]], dim=1)
    top = torch.cat([rot_mats, rel_joints[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rot_mats.dtype,
                          device=rot_mats.device).expand(N, K, 1, 4)
    local = torch.cat([top, bottom], dim=-2)
    world = [local[:, 0]] + [None] * (K - 1)
    for ids, pids in tsmpl._depth_groups(parents):
        prod = (torch.stack([world[p] for p in pids], dim=1)
                @ local[:, list(ids)])
        for j, k in enumerate(ids):
            world[k] = prod[:, j]
    world = torch.stack(world, dim=1)
    posed_joints = world[..., :3, 3]
    joints_homo = torch.cat([joints, torch.zeros_like(joints[..., :1])], -1)
    correction = (world @ joints_homo[..., None])[..., 0]
    rel = torch.cat([world[..., :3], (world[..., 3] - correction)[..., None]],
                    dim=-1)
    return posed_joints, rel


def _rotmats(n, seed):
    g = torch.Generator().manual_seed(seed)
    q, _ = torch.linalg.qr(torch.randn((n, 24, 3, 3), generator=g))
    return q


def _site_chain():
    rot = _rotmats(3, 0).requires_grad_(True)
    joints = torch.randn((3, 24, 3),
                         generator=torch.Generator().manual_seed(1))
    got = tsmpl._rigid_transform_chain(rot, joints, tsmpl.SMPL_PARENTS)
    want = _chain_uncached(rot, joints, tsmpl.SMPL_PARENTS)
    g_got = torch.autograd.grad(sum(t.sum() for t in got), rot)
    g_want = torch.autograd.grad(sum(t.sum() for t in want), rot)
    return [*got, *g_got], [*want, *g_want]


def _site_spin_gather():
    model = tsmpl.synthetic_smpl_model(2, "cpu", num_vertices=F.NV)
    verts = torch.randn((2, F.NV, 3),
                        generator=torch.Generator().manual_seed(2))
    kin = torch.randn((2, 24, 3), generator=torch.Generator().manual_seed(3))
    joints54 = torch.cat([kin, verts[:, model.vertex_joint_ids], torch.einsum(
        "jv,nvc->njc", model.J_regressor_extra, verts)], dim=1)
    want = joints54[:, torch.as_tensor(constants.SPIN_JOINT_GATHER,
                                       dtype=torch.long)]
    return [tsmpl.spin_joints(model, verts, kin)], [want]


def _site_angle_prior():
    pose = torch.randn((4, 72), generator=torch.Generator().manual_seed(4))
    got, want = [], []
    for full in (False, True):
        p = pose if full else pose[:, 3:]
        off = 0 if full else 3
        idxs = [i - off for i in priors._ANGLE_IDXS]
        signs = torch.tensor(priors._ANGLE_SIGNS, dtype=p.dtype)
        want.append(torch.exp(p[:, idxs] * signs) ** 2)
        got.append(priors.angle_prior(p, with_global_pose=full))
    return got, want


def _site_focal_length():
    g = torch.Generator().manual_seed(5)
    pts = torch.randn((2, 10, 3), generator=g) + torch.tensor([0.0, 0.0, 10.0])
    rot = _rotmats(2, 6)[:, 0]
    t, c = torch.randn((2, 3), generator=g), torch.randn((2, 2), generator=g)
    projected = torch.einsum("bij,bkj->bki", rot, pts) + t[:, None, :]
    projected = projected / projected[..., 2:3]
    f = torch.as_tensor(5000.0, dtype=pts.dtype).expand(2)
    want = projected[..., :2] * f[:, None, None] + c[:, None, :]
    return [camera.perspective_projection(pts, rot, t, 5000.0, c)], [want]


@pytest.mark.parametrize("site", [_site_chain, _site_spin_gather,
                                  _site_angle_prior, _site_focal_length],
                         ids=lambda f: f.__name__[6:])
def test_cached_constants_bit_equal(site):
    got, want = site()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_device_const_made_once():
    a = device_const((1, 2, 3), torch.long, "cpu")
    assert a is device_const((1, 2, 3), torch.long, torch.device("cpu"))
    assert a is not device_const((1, 2, 3), torch.float32, "cpu")
    assert a.tolist() == [1, 2, 3]


# -- the engine --------------------------------------------------------------

def _engine(cfg):
    net = HMR(layers=F.LAYERS, width=F.WIDTH, regressor_dim=F.RDIM)
    init_weights_(net, torch.Generator().manual_seed(0))
    store = F.t_store(6, F.CPU, img_res=F.IMG, feat_dim=F.XF)
    eng = teng.BilevelEngine(cfg, net.eval(), F.t_prior(4, F.CPU),
                             F.torch_smpls(), store)
    return eng, {k: v.detach() for k, v in net.named_parameters()}


def _frames(name, n):
    frames = [F.torch_frame(f) for f in F.make_frames(n, seed=3)]
    if name != "window2":
        return frames
    # B = 2 windows; the last one's second row a masked pad
    out = []
    for i in range(0, n, 2):
        a, b = frames[i], frames[min(i + 1, n - 1)]
        fr = teng.Frame(*[torch.cat([x, y]) for x, y in zip(a[:5], b[:5])])
        mask = torch.tensor([1.0, 1.0 if i + 1 < n else 0.0])
        out.append(fr._replace(mask=mask))
    return out


def _evaluations(outs, cfg):
    """Gradient evaluations the step made over ``outs``."""
    per = cfg.inner_step if cfg.use_boa else 1
    return sum(per + (int(o["optim_steps"]) + 1 if cfg.use_boa else 0)
               for o in outs)


def _flat(out, prefix=""):
    flat = {}
    for k, v in out.items():
        if isinstance(v, dict):
            flat.update(_flat(v, f"{prefix}{k}/"))
        elif isinstance(v, torch.Tensor):
            flat[prefix + k] = v.detach().clone()
        else:
            flat[prefix + k] = v
    return flat


def _run(eng, params, frames, state=None):
    state = state or eng.init_state(
        params, batch_size=frames[0].image.shape[0], img_res=F.IMG)
    outs = []
    for fr in frames:
        state, out = eng.step(state, fr, cos_sim_threshold=-1.0)
        outs.append(out)
    return state, outs


def _assert_same(outs_a, outs_b, state_a, state_b):
    for a, b in zip(outs_a, outs_b):
        fa, fb = _flat(a), _flat(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            if isinstance(fa[k], torch.Tensor):
                assert torch.equal(fa[k], fb[k]), k
            else:
                assert fa[k] == fb[k], k
    for k in state_a.params:
        assert torch.equal(state_a.params[k], state_b.params[k]), k
        assert torch.equal(state_a.teacher_params[k],
                           state_b.teacher_params[k]), k
        ma = state_a.optimizer.state[state_a.params[k]]
        mb = state_b.optimizer.state[state_b.params[k]]
        assert torch.equal(ma["exp_avg"], mb["exp_avg"]), k
        assert torch.equal(ma["exp_avg_sq"], mb["exp_avg_sq"]), k


@pytest.mark.parametrize("name", ["retrieval_motion", "no_boa"])
def test_cpu_engine_runs_every_evaluation_eagerly(name):
    cfg = CONFIGS[name]
    eng, params = _engine(cfg)
    state, outs = _run(eng, params, _frames(name, 4))
    assert eng.graph_stats == {"eager": _evaluations(outs, cfg),
                               "captures": 0, "replays": 0,
                               "capture_ms": 0.0}
    assert not state.graphs._graphs


@pytest.mark.parametrize("change", ["level", "params", "mixtrain", "mask",
                                    "history", "batch", "image_res", "dtype",
                                    "exemplars"])
def test_grad_key_changes(change):
    fr = F.torch_frame(F.make_frames(1)[0])
    eng, params = _engine(CONFIGS["retrieval_motion"])
    state = eng.init_state(params, img_res=F.IMG)
    bank = eng.store.bank.take(slice(0, 1))
    hist = eng._history(state)
    base = ("upper", True, fr, hist, bank)
    args = list(base)
    if change == "level":
        args[0] = "lower"
    elif change == "params":
        args[1] = False
    elif change == "mixtrain":
        args[4] = None
    elif change == "mask":
        args[2] = fr._replace(mask=torch.ones((1,)))
    elif change == "history":
        args[3] = None
    elif change == "batch":
        args[2] = teng.Frame(*[torch.cat([x, x]) for x in fr[:5]])
    elif change == "image_res":
        args[2] = fr._replace(image=fr.image[:, :16, :16])
    elif change == "dtype":
        args[2] = fr._replace(j2d=fr.j2d.double())
    elif change == "exemplars":
        args[4] = eng.store.bank.take(slice(0, 2))
    assert eng._grad_key(*args) != eng._grad_key(*base)
    # the values read are not part of the key
    same = (base[0], base[1], fr._replace(image=fr.image + 1.0), hist, bank)
    assert eng._grad_key(*same) == eng._grad_key(*base)


class _EagerGraph(graphs._Graph):
    """The CUDA graph's stand-in: recording runs the evaluation; a replay
    runs it again on the graph's buffers and writes what it gives into the
    recorded output tensors."""

    def capture(self, fn, pool):
        self.fn = fn
        loss, feats, aux, grads = fn(*self.inputs)
        self.out = (torch.stack([loss, *aux.values()]), list(aux), feats,
                    grads)

    def replay(self):
        loss, feats, aux, grads = self.fn(*self.inputs)
        vec, names, f0, g0 = self.out
        assert names == list(aux)
        with torch.no_grad():
            torch._foreach_copy_([vec, *f0, *g0],
                                 [torch.stack([loss, *aux.values()]), *feats,
                                  *grads])


@pytest.fixture()
def stand_in(monkeypatch):
    monkeypatch.setattr(graphs, "_Graph", _EagerGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: object())

    def graphed(cfg):
        eng, params = _engine(cfg)
        eng._graphed = True
        return eng, params

    return graphed


@pytest.mark.parametrize("name", list(CONFIGS))
def test_graph_path_equals_eager(stand_in, name):
    cfg = CONFIGS[name]
    frames = _frames(name, 7 if name == "window2" else 5)
    eng, params = _engine(cfg)
    state_e, outs_e = _run(eng, params, frames)
    geng, _ = stand_in(cfg)
    state_g, outs_g = _run(geng, params, frames)
    _assert_same(outs_e, outs_g, state_e, state_g)
    n_keys = len(state_g.graphs._graphs)
    stats = geng.graph_stats
    assert stats["eager"] == stats["captures"] == n_keys > 0
    assert stats["replays"] == _evaluations(outs_g, cfg) - 2 * n_keys > 0
    assert eng.graph_stats["eager"] == _evaluations(outs_e, cfg)


def test_graph_path_records_outlive_later_steps(stand_in):
    """Frame t's outputs (the loss terms the graphs wrote among them) are
    unchanged after frames t+1 and t+2, as the stream app's depth-2
    pipeline reads them."""
    cfg = CONFIGS["retrieval_motion"]
    eng, params = stand_in(cfg)
    frames = _frames("retrieval_motion", 6)
    state, outs = _run(eng, params, frames[:4])
    assert eng.graph_stats["replays"] > 0
    kept = _flat(outs[-1])
    _run(eng, params, frames[4:], state)
    now = _flat(outs[-1])
    for k in kept:
        if isinstance(kept[k], torch.Tensor):
            assert torch.equal(kept[k], now[k]), k


def test_graph_path_new_state_and_replaced_weights(stand_in):
    """A second state on a warm engine captures its keys on their first
    call; a state whose weights move to another storage captures anew and
    still gives the eager path's numbers."""
    cfg = CONFIGS["retrieval_motion"]
    frames = _frames("retrieval_motion", 4)
    eng, params = stand_in(cfg)
    _run(eng, params, frames)
    before = dict(eng.graph_stats)
    state, outs = _run(eng, params, frames[:2])
    n_keys = len(state.graphs._graphs)
    assert eng.graph_stats["eager"] == before["eager"]
    assert eng.graph_stats["captures"] == before["captures"] + n_keys

    ref_eng, _ = _engine(cfg)
    ref_state, ref_outs = _run(ref_eng, params, frames[:2])
    with torch.no_grad():
        for p in state.params.values():
            p.data = p.data.clone()
    before = dict(eng.graph_stats)
    state, outs = _run(eng, params, frames[2:], state)
    ref_state, ref_outs = _run(ref_eng, params, frames[2:], ref_state)
    assert eng.graph_stats["captures"] > before["captures"]
    _assert_same(ref_outs, outs, ref_state, state)
    assert len(state.graphs._graphs) == n_keys


def test_graph_spans_nest_in_the_gradient_spans(stand_in):
    """Under ``torch.profiler`` a capture is the span ``step.grad.capture``
    and a replay ``step.grad.replay``, each inside its level's
    ``step.grad.lower`` or ``step.grad.upper``."""
    from tests.test_torch_tracing import _inside, _profiled

    cfg = CONFIGS["retrieval_motion"]
    eng, params = stand_in(cfg)
    frames = _frames("retrieval_motion", 3)
    state = eng.init_state(params, img_res=F.IMG)
    state, _ = eng.step(state, frames[0], cos_sim_threshold=-1.0, extra_cap=0)

    def two():
        for fr in frames[1:]:
            eng.step(state, fr, cos_sim_threshold=-1.0, extra_cap=0)

    _, spans = _profiled(two)
    levels = [s for s in spans if s["name"] in ("step.grad.lower",
                                                "step.grad.upper")]
    inner = [s for s in spans if s["name"] in ("step.grad.capture",
                                               "step.grad.replay")]
    assert [s["name"] for s in inner] == ["step.grad.capture"] * 2 + \
        ["step.grad.replay"] * 2
    assert [s["name"] for s in levels] == ["step.grad.lower",
                                           "step.grad.upper"] * 2
    assert all(_inside(s, lv) for s, lv in zip(inner, levels))
