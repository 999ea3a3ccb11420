"""Composed per-frame step with ``compute_dtype="bfloat16"``: the port's
engine against the JAX engine from the same weights over 4 frames, every
update taken (threshold -1, ``optim_steps=2``), and a trajectory check of
the port's bf16 run against its fp32 run in the spirit of the JAX bench's
``qualify_bf16_trajectory``.

bf16 rounding is not the same in the two packages: XLA on the CPU may keep
a convolution's float32 result where the program rounds it to bfloat16
(``--xla_allow_excess_precision``, on by default), oneDNN rounds it.  So
the JAX engine's bf16 run lies closer to fp32 than the port's.  Measured
over these 4 frames (CPU, these sizes), largest relative loss difference:
port bf16 vs JAX bf16 7.5e-2 (frame 3); port bf16 vs port fp32 6.5e-2;
JAX bf16 vs JAX fp32 0.9e-2, and 5.8e-2 with the excess precision turned
off (then port bf16 vs JAX bf16 is 2.4e-2).  The losses are held at
``BF16_LOSS_RTOL`` = 0.1.

The weights and teacher are held to the JAX package's own bf16-vs-fp32
gap, as ``test_torch_hmr_bf16.py`` holds the outputs.  Measured L2 norms of
(port bf16 - JAX bf16) over (JAX bf16 - JAX fp32), params and teacher
alike: whole tree 1.50, per leaf median 1.33 and largest 2.73; a port fp32
engine reads 1.00 (it sits where JAX fp32 does), and the gap itself is
0.25 of the update's norm.  Held at ``TREE_GAP_RATIO`` = 2 and
``LEAF_GAP_RATIO`` = 4; an update of unrelated direction and the same size
would read about 5.6 on the tree.  The largest coordinate difference, 1.13
times the fp32 Adam drift bound n_updates * lr (bf16 gradients flip the
sign of more near-zero Adam steps), is kept under twice that bound as a
sanity check.

The 8-frame trajectory holds the port's (bf16 - fp32) weight gap to JAX's
over the same frames: measured whole-tree ratio 1.38, held within
[1/2, 2], so an engine that quietly ran fp32 (ratio ~0) fails; the
JAX bench's criterion, every coordinate within 4 * n_updates * lr, is
kept beside it."""

import jax
import numpy as np
import pytest
import torch

from dynaboa_tpu import engine as jeng
from dynaboa_tpu.config import AdaptConfig
from dynaboa_tpu.losses import synthetic_gmm_prior as j_prior
from dynaboa_tpu.models.hmr import HMR as JHMR
from dynaboa_tpu_torch.engine import bilevel as teng
from dynaboa_tpu_torch.models.hmr import HMR as THMR, params_from_jax
from tests import torch_port_fixtures as F

CFG = AdaptConfig(interval=2, optim_steps=2, cos_sim_threshold=-1.0,
                  retrieval=False, use_pallas_lbs=True,
                  compute_dtype="bfloat16")
N_FRAMES = 4
TRAJ_FRAMES = 8
BF16_LOSS_RTOL = 0.1
TREE_GAP_RATIO = 2.0
LEAF_GAP_RATIO = 4.0


def _torch_net(jparams, compute_dtype):
    net = THMR(layers=F.LAYERS, width=F.WIDTH, regressor_dim=F.RDIM,
               compute_dtype=compute_dtype)
    net.load_state_dict(params_from_jax(jparams), strict=False)
    return net.eval()


def _torch_engine(cfg, jparams):
    tstore = F.t_store(6, F.CPU, img_res=F.IMG, feat_dim=F.XF)
    return teng.BilevelEngine(cfg, _torch_net(jparams, cfg.compute_dtype),
                              F.t_prior(4, F.CPU), F.torch_smpls(), tstore)


def _engines(dtype, jparams):
    cfg = CFG.replace(compute_dtype=dtype)
    jmodel = JHMR(layers=F.LAYERS, width=F.WIDTH, regressor_dim=F.RDIM,
                  compute_dtype=dtype)
    jstore = jeng.synthetic_store(seed=6, img_res=F.IMG, feat_dim=F.XF)
    jengine = jeng.BilevelEngine(cfg, jmodel, j_prior(seed=4), F.jax_smpls(),
                                 jstore)
    tengine = _torch_engine(cfg, jparams)
    return dict(jengine=jengine, jparams=jparams, tengine=tengine,
                tparams={k: v.detach()
                         for k, v in tengine.model.named_parameters()})


@pytest.fixture(scope="module")
def engines():
    """bf16 and fp32 engines of both packages from the same weights: two
    JAX compiles for the module."""
    _, jparams = F.jax_hmr()
    return {dtype: _engines(dtype, jparams)
            for dtype in ("bfloat16", "float32")}


def _leaves(tree, port: bool) -> list[np.ndarray]:
    if port:
        tree = F.port_params_as_flax(tree)
    return [np.asarray(x, np.float64) for x in jax.tree.leaves(tree)]


def _gap_norms(a, b) -> tuple[float, np.ndarray]:
    """L2 norm of (a - b) over the whole tree and per leaf."""
    per_leaf = np.asarray([np.linalg.norm(x - y) for x, y in zip(a, b)])
    return float(np.sqrt((per_leaf ** 2).sum())), per_leaf


@pytest.fixture(scope="module")
def run(engines):
    """The port's in-loss decodes are recorded along the way; the fp32
    engines step the same frames for JAX's own bf16-vs-fp32 gap."""
    frames = F.make_frames(N_FRAMES, seed=3)
    tengine = engines["bfloat16"]["tengine"]
    decode = tengine._decode
    dtypes = set()

    def recording(rotmat, shape, no_grad=False):
        s3d, verts = decode(rotmat, shape, no_grad)
        if not no_grad:
            dtypes.update({rotmat.dtype, shape.dtype, s3d.dtype, verts.dtype})
        return s3d, verts

    tengine._decode = recording
    try:
        out = F.run_both(engines["bfloat16"], frames)
    finally:
        del tengine._decode
    out["in_loss_decode_dtypes"] = dtypes
    out["fp32"] = F.run_both(engines["float32"], frames)
    return out


def test_step_counts_identical(run):
    F.assert_step_counts(run)
    assert [int(o["optim_steps"]) for o in run["touts"]] == [2] * N_FRAMES


def test_losses_within_bf16_tolerance(run):
    for jo, to in zip(run["jouts"], run["touts"]):
        for level in ("lower", "upper"):
            np.testing.assert_allclose(to[level]["loss"], jo[level]["loss"],
                                       rtol=BF16_LOSS_RTOL,
                                       atol=F.LOSS_ATOL)
        np.testing.assert_allclose(to["per_step_loss"], jo["per_step_loss"],
                                   rtol=BF16_LOSS_RTOL, atol=F.LOSS_ATOL)


@pytest.mark.parametrize("tree", ["params", "teacher_params"])
def test_weights_within_jax_bf16_gap(run, tree):
    port16 = _leaves(getattr(run["tstate"], tree), port=True)
    jax16 = _leaves(getattr(run["jstate"], tree), port=False)
    jax32 = _leaves(getattr(run["fp32"]["jstate"], tree), port=False)
    err, err_leaf = _gap_norms(port16, jax16)
    gap, gap_leaf = _gap_norms(jax16, jax32)
    assert gap > 0.0
    assert err <= TREE_GAP_RATIO * gap, (err, gap)
    worst = int(np.argmax(err_leaf / gap_leaf))
    assert err_leaf[worst] <= LEAF_GAP_RATIO * gap_leaf[worst], \
        (worst, err_leaf[worst], gap_leaf[worst])
    assert max(float(np.abs(x - y).max()) for x, y in zip(port16, jax16)) \
        < 2 * F.adam_drift_bound(CFG, run)


def test_state_stays_fp32(run):
    st = run["tstate"]
    for k, p in st.params.items():
        assert p.dtype == torch.float32 and \
            st.teacher_params[k].dtype == torch.float32, k
    for group in st.optimizer.state.values():
        for v in group.values():
            assert v.dtype == torch.float32
    for o in run["touts"]:
        for k in ("verts", "rotmat", "beta", "cam", "mpjpe", "per_step_loss",
                  "per_step_sims"):
            assert o[k].dtype == np.float32, k


def test_in_loss_decode_is_fp32(run):
    assert run["in_loss_decode_dtypes"] == {torch.float32}


def test_bf16_trajectory_gap_matches_jax(engines):
    """8 frames in bf16 and in fp32 from identical weights, in both
    packages: the port's bf16-vs-fp32 weight gap is within a factor 2 of
    JAX's, every coordinate within 4 * n_updates * lr (the JAX bench's
    weight-drift criterion), and the bf16 run's metrics are finite."""
    frames = F.make_frames(TRAJ_FRAMES, seed=7)
    runs = {dtype: F.run_both(engines[dtype], frames)
            for dtype in ("bfloat16", "float32")}
    n_updates = sum(int(o["optim_steps"]) + 1
                    for o in runs["bfloat16"]["touts"])
    assert n_updates == TRAJ_FRAMES * (1 + CFG.optim_steps)
    port = {d: _leaves(r["tstate"].params, port=True) for d, r in runs.items()}
    jax_ = {d: _leaves(r["jstate"].params, port=False)
            for d, r in runs.items()}
    port_gap, _ = _gap_norms(port["bfloat16"], port["float32"])
    jax_gap, _ = _gap_norms(jax_["bfloat16"], jax_["float32"])
    assert 0.5 * jax_gap <= port_gap <= 2.0 * jax_gap, (port_gap, jax_gap)
    drift = max(float(np.abs(a - b).max())
                for a, b in zip(port["bfloat16"], port["float32"]))
    assert 0.0 < drift <= 4 * n_updates * CFG.lr, drift
    for o in runs["bfloat16"]["touts"]:
        for k in ("mpjpe", "pampjpe", "pve"):
            assert np.isfinite(o[k]).all(), k
