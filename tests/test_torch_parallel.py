"""The port's independent adaptation streams (``parallel/streams.py``): the
counterparts of tests/test_parallel.py, with ``devices=[cpu, cpu]`` standing
for two devices, and ``run_parallel`` against the JAX package's on the same
streams."""

import numpy as np
import pytest
import torch

from dynaboa_tpu import engine as jeng
from dynaboa_tpu.config import AdaptConfig
from dynaboa_tpu_torch.engine import bilevel as teng
from dynaboa_tpu_torch.engine.runner import frame_from_item
from dynaboa_tpu_torch.parallel import streams as P
from tests import torch_port_fixtures as F

CPU2 = [F.CPU, F.CPU]
# the port-only tests: bilevel with retrieval, mixtrain and the teacher on,
# one update per frame (small and fast, but every private buffer moves)
PORT_CFG = AdaptConfig(dynamic_boa=False, use_motion=False,
                       record_lowerlevel=False)
# tests/test_parallel.py's light config, for the run against JAX
LIGHT_CFG = AdaptConfig(dynamic_boa=False, use_meanteacher=False,
                        use_motion=False, retrieval=False,
                        lower_level_mixtrain=False,
                        upper_level_mixtrain=False, record_lowerlevel=False)


def make_items(seed: int, n: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{
        "image": rng.normal(size=(F.IMG, F.IMG, 3)).astype(np.float32),
        "smpl_j2d": np.concatenate(
            [rng.uniform(-1, 1, (49, 2)), np.ones((49, 1))], -1
        ).astype(np.float32),
        "pose": rng.normal(scale=0.2, size=72).astype(np.float32),
        "betas": rng.normal(scale=0.3, size=10).astype(np.float32),
        "gender": i % 2,
    } for i in range(n)]


def port_engine(cfg=PORT_CFG):
    _, jparams = F.jax_hmr()
    net = F.torch_hmr_from(jparams)
    eng = teng.BilevelEngine(
        cfg, net, F.t_prior(4, F.CPU), F.torch_smpls(),
        F.t_store(6, F.CPU, img_res=F.IMG, feat_dim=F.XF))
    return eng, {k: v.detach() for k, v in net.named_parameters()}


@pytest.fixture(scope="module")
def setup():
    return port_engine()


def _frames(items):
    return [frame_from_item(it, F.CPU) for it in items]


def _params(state):
    return {k: v.detach().clone() for k, v in state.params.items()}


def test_round_robin_placement_and_private_buffers(setup):
    eng, params = setup
    par = P.ParallelStreams(eng, CPU2)
    states = par.init_states(params, 4, img_res=F.IMG)
    assert [par.device_of(s) for s in range(4)] == [F.CPU] * 4
    assert par.engine_for(F.CPU) is eng    # one engine per device
    ptrs = [states[s].params["conv1.weight"].data_ptr() for s in range(4)]
    assert len(set(ptrs)) == 4
    assert len({st.hist_images.data_ptr() for st in states}) == 4
    before = [_params(st) for st in states]
    eng.step(states[0], frame_from_item(make_items(1, 1)[0], F.CPU))
    assert not torch.equal(states[0].params["conv1.weight"],
                           before[0]["conv1.weight"])
    for s in (1, 2, 3):
        for k, v in states[s].params.items():
            assert torch.equal(v, before[s][k]), (s, k)
        assert states[s].step == 0


def test_stream0_bit_identical_to_bare_engine_step(setup):
    eng, params = setup
    par = P.ParallelStreams(eng, CPU2)
    items = make_items(2, 4)
    states = par.init_states(params, 4, img_res=F.IMG)
    states, outs = par.step(states, _frames(items))
    bare = eng.init_state(params, img_res=F.IMG)
    bare.rng.manual_seed(P.stream_seed(PORT_CFG.seed, 0))
    bare, out = eng.step(bare, frame_from_item(items[0], F.CPU))
    for k in ("mpjpe", "pampjpe", "pve", "verts"):
        assert torch.equal(out[k], outs[0][k]), k
    for k, v in bare.params.items():
        assert torch.equal(v, states[0].params[k]), k
    assert torch.equal(bare.rng.get_state(), states[0].rng.get_state())


def test_stream0_unchanged_when_other_streams_change(setup):
    eng, params = setup
    par = P.ParallelStreams(eng, CPU2)
    items = make_items(3, 4)
    out_a = P.stack_outs(par.step(par.init_states(params, 4, img_res=F.IMG),
                                  _frames(items))[1])
    items_b = items[:1] + make_items(4, 3)
    out_b = P.stack_outs(par.step(par.init_states(params, 4, img_res=F.IMG),
                                  _frames(items_b))[1])
    for k in ("mpjpe", "pampjpe", "pve", "verts"):
        np.testing.assert_array_equal(out_a[k][0], out_b[k][0])
    assert not np.array_equal(out_a["mpjpe"][1:], out_b["mpjpe"][1:])
    assert out_a["upper"]["loss"].shape == (4,)


def test_stream_seeds_are_distinct_and_fixed():
    seeds = [P.stream_seed(22, s) for s in range(8)]
    assert len(set(seeds)) == 8
    assert seeds == [P.stream_seed(22, s) for s in range(8)]
    assert P.stream_seed(23, 0) not in seeds


def test_share_weights_average_params_keep_adam_and_teacher(setup):
    eng, params = setup
    items = make_items(5, 4)
    frames = _frames(items)
    indep = P.ParallelStreams(eng, CPU2)
    ind_states, _ = indep.step(indep.init_states(params, 4, img_res=F.IMG),
                               frames)
    shared = P.ParallelStreams(eng, CPU2, share_weights=True)
    sh_states, outs = shared.step(
        shared.init_states(params, 4, img_res=F.IMG), frames)
    for k in params:
        mean = torch.stack([st.params[k] for st in ind_states]).mean(0)
        for st in sh_states:
            assert torch.equal(st.params[k], mean), k
    # private: Adam moments and the teacher (EMA'd before the average)
    k = "fc1.weight"
    moments = [st.optimizer.state[st.params[k]]["exp_avg"] for st in sh_states]
    assert not torch.equal(moments[0], moments[1])
    assert not torch.equal(sh_states[0].teacher_params[k],
                           sh_states[1].teacher_params[k])
    for s in range(4):
        assert torch.equal(sh_states[s].teacher_params[k],
                           ind_states[s].teacher_params[k])
    assert np.isfinite(P.stack_outs(outs)["mpjpe"]).all()


def test_share_weights_rejects_indivisible_stream_count(setup):
    eng, params = setup
    par = P.ParallelStreams(eng, CPU2, share_weights=True)
    with pytest.raises(ValueError, match="divisible"):
        par.init_states(params, 3, img_res=F.IMG)


def test_engine_on_another_device_steps_alike(setup):
    """The per-device engine (a copy of every asset) steps bit-equal to the
    engine itself."""
    eng, params = setup
    copy_ = P._engine_on(eng, F.CPU)
    assert copy_.model is not eng.model and copy_.smpls is not eng.smpls
    frame = frame_from_item(make_items(6, 1)[0], F.CPU)
    outs = [e.step(e.init_state(params, img_res=F.IMG), frame)[1]
            for e in (eng, copy_)]
    for k in ("mpjpe", "verts"):
        assert torch.equal(outs[1][k], outs[0][k]), k


def test_stack_frames_leading_stream_axis():
    items = make_items(14, 3)
    stacked = P.stack_frames(items, F.CPU)
    for s, fr in enumerate(_frames(items)):
        for k in P.Frame._fields:
            if getattr(fr, k) is None:      # the box of a box-less model
                assert getattr(stacked, k) is None, k
                continue
            assert torch.equal(getattr(stacked, k)[s], getattr(fr, k)), k


def test_make_mesh_raises_rather_than_clamps():
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="available"):
        P.make_mesh(n + 1)
    with pytest.raises(ValueError):
        P.make_mesh(0)


class _Counting:
    seq_lengths = [3, 2, 3]

    def __init__(self):
        self.loads = []

    def __len__(self):
        return 8

    def __getitem__(self, i):
        self.loads.append(i)
        return {"idx": i}


def test_partition_is_lazy_and_deals_whole_tracks():
    stream = _Counting()
    groups = P.partition_items(stream, 2)
    assert stream.loads == []                       # nothing loaded eagerly
    assert [len(g) for g in groups] == [6, 2]
    assert [it["idx"] for it in groups[0]] == [0, 1, 2, 5, 6, 7]
    assert [it["idx"] for it in groups[1]] == [3, 4]
    assert groups[0][3]["idx"] == 5                 # random access, lazy
    flat = P.partition_items(list(range(8)), 3)     # no tracks: contiguous
    assert [list(g) for g in flat] == [[0, 1, 2], [3, 4, 5], [6, 7]]


def test_run_parallel_frame_weighted_with_an_empty_stream(setup):
    eng, params = setup
    groups = [make_items(7, 3), make_items(8, 1), []]
    summary = P.run_parallel(eng, params, groups, devices=CPU2,
                             log=lambda *a: None)
    per = summary["per_stream"]
    assert [p["frames"] for p in per] == [3, 1, 0] == \
        [len(g) for g in groups]
    assert summary["frames"] == 4
    assert np.isnan(per[2]["mpjpe"])
    for k in ("mpjpe", "pampjpe", "pve"):
        want = (3 * per[0][k] + per[1][k]) / 4
        np.testing.assert_allclose(summary[k], want, rtol=1e-12)
        assert np.isfinite(summary[k])
    assert summary["fps"] > 0


def test_run_parallel_stream_independent_of_its_neighbours(setup):
    """Stream 0's results are the same beside another stream of other
    frames, and beside none."""
    eng, params = setup
    a = make_items(9, 2)
    runs = [P.run_parallel(eng, params, groups, devices=CPU2,
                           log=lambda *a: None)["per_stream"]
            for groups in ([a, make_items(10, 2)], [a, make_items(15, 3)],
                           [a])]
    assert runs[0][0] == runs[1][0] == runs[2][0]
    assert runs[0][1] != runs[1][1]


def test_run_parallel_logs_progress(setup):
    eng, params = setup
    lines = []
    P.run_parallel(eng, params, [make_items(16, 2), make_items(17, 2)],
                   devices=CPU2, log=lines.append, progress_every=2)
    progress = [ln for ln in lines if "dispatched" in ln]
    assert [ln.split("dispatched ")[1].split()[0] for ln in progress] == \
        ["2", "4"]
    assert all("RSS" in ln for ln in progress)
    assert "4 frames over 2 device(s)" in lines[-1]


def test_run_parallel_raises_a_failed_stream(setup):
    eng, params = setup
    bad = make_items(11, 2)
    del bad[1]["pose"]
    with pytest.raises(KeyError, match="pose"):
        P.run_parallel(eng, params, [make_items(12, 2), bad], devices=CPU2,
                       log=lambda *a: None)


def test_run_parallel_refuses_all_empty_streams(setup):
    eng, params = setup
    with pytest.raises(ValueError, match="every stream is empty"):
        P.run_parallel(eng, params, [[], []], devices=CPU2)


def test_run_parallel_matches_jax():
    """Both packages' run_parallel over the same 2 streams of 3 frames
    (JAX on a one-device mesh): the same frames per stream, and metric
    means within METRIC_ATOL_MM."""
    from dynaboa_tpu.parallel.streams import make_mesh as jmake_mesh
    from dynaboa_tpu.parallel.streams import run_parallel as jrun_parallel

    jstore = jeng.synthetic_store(seed=6, img_res=F.IMG, feat_dim=F.XF)
    tstore = F.t_store(6, F.CPU, img_res=F.IMG, feat_dim=F.XF)
    engines = F.build_engines(LIGHT_CFG, jstore, tstore)
    items = make_items(13, 6)
    groups = [items[:3], items[3:]]
    quiet = dict(log=lambda *a: None)
    jsum = jrun_parallel(engines["jengine"], engines["jparams"], groups,
                         mesh=jmake_mesh(1), **quiet)
    tsum = P.run_parallel(engines["tengine"], engines["tparams"], groups,
                          devices=[F.CPU], **quiet)
    assert tsum["frames"] == jsum["frames"] == 6
    for j, t in zip(jsum["per_stream"], tsum["per_stream"]):
        assert t["frames"] == j["frames"] == 3
        for k in ("mpjpe", "pampjpe", "pve"):
            np.testing.assert_allclose(t[k], j[k], rtol=0,
                                       atol=F.METRIC_ATOL_MM, err_msg=k)
    for k in ("mpjpe", "pampjpe", "pve"):
        np.testing.assert_allclose(tsum[k], jsum[k], rtol=0,
                                   atol=F.METRIC_ATOL_MM, err_msg=k)
