"""Shared tiny fixtures for the PyTorch-port parity tests (tests/test_torch_*).

Both packages get the same inputs: weights are the JAX package's flax
params carried across with ``params_from_jax``; SMPL bodies, prior, store
and frames come from the same numpy seeds.  Sizes follow tests/test_engine.py.
"""

from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp
import torch

from dynaboa_tpu import engine as jeng
from dynaboa_tpu.losses import synthetic_gmm_prior as j_synthetic_gmm_prior
from dynaboa_tpu.metrics import GenderedSMPL as JGenderedSMPL
from dynaboa_tpu.models import synthetic_smpl_model as j_synthetic_smpl
from dynaboa_tpu.models.hmr import HMR as JHMR, init_hmr_params
from dynaboa_tpu.models.hmr import convert_torch_state_dict

from dynaboa_tpu_torch.engine import bilevel as teng
from dynaboa_tpu_torch.engine.retrieval import (build_store as t_build_store,
                                                synthetic_store as t_store)
from dynaboa_tpu_torch.losses.priors import synthetic_gmm_prior as t_prior
from dynaboa_tpu_torch.metrics.eval import GenderedSMPL as TGenderedSMPL
from dynaboa_tpu_torch.models.hmr import HMR as THMR, params_from_jax
from dynaboa_tpu_torch.models.smpl import synthetic_smpl_model as t_smpl



def _share_cores_between_test_workers():
    """Under pytest-xdist each worker process has its own torch thread pool
    of one thread per core; the spinning OpenMP threads of several workers
    on the same cores slowed the port's tests about sevenfold.  Each worker
    takes its share of the cores instead.  Every tests/test_torch_* module
    that runs torch work imports this module, so this runs in each worker."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(workers)))


_share_cores_between_test_workers()

IMG = 32
WIDTH = 16
LAYERS = (1, 1, 1, 1)
RDIM = 128
NV = 256
XF = WIDTH * 8 * 4
CPU = torch.device("cpu")


def jreg_h36m(nv: int = NV) -> np.ndarray:
    return np.random.default_rng(5).dirichlet(np.ones(nv), size=17).astype(
        np.float32)


def jax_hmr(seed: int = 0):
    model = JHMR(layers=LAYERS, width=WIDTH, regressor_dim=RDIM)
    params = init_hmr_params(model, jax.random.PRNGKey(seed),
                             input_shape=(1, IMG, IMG, 3))
    return model, params


def torch_hmr_from(flax_params) -> THMR:
    net = THMR(layers=LAYERS, width=WIDTH, regressor_dim=RDIM)
    net.load_state_dict(params_from_jax(flax_params), strict=False)
    return net.eval()


def jax_smpls():
    return JGenderedSMPL(
        neutral=j_synthetic_smpl(seed=10, num_vertices=NV),
        male=j_synthetic_smpl(seed=11, num_vertices=NV),
        female=j_synthetic_smpl(seed=12, num_vertices=NV),
        J_regressor_h36m=jnp.asarray(jreg_h36m()))


def torch_smpls():
    return TGenderedSMPL(
        neutral=t_smpl(10, CPU, num_vertices=NV),
        male=t_smpl(11, CPU, num_vertices=NV),
        female=t_smpl(12, CPU, num_vertices=NV),
        J_regressor_h36m=torch.as_tensor(jreg_h36m()))


def singleton_stores(n_clusters: int = 6, img_res: int = IMG):
    """A store with one member per cluster (both packages' draws are then
    deterministic), built from the first exemplars of the synthetic store."""
    jbase = jeng.synthetic_store(seed=6, img_res=img_res, feat_dim=XF)
    tbase = t_store(6, CPU, img_res=img_res, feat_dim=XF)
    centers = np.random.default_rng(21).normal(
        size=(n_clusters, XF)).astype(np.float32)
    members = [[i] for i in range(n_clusters)]
    jbank = jeng.retrieval.ExemplarBank(*[a[:n_clusters] for a in jbase.bank])
    tbank = tbase.bank.take(slice(0, n_clusters))
    return (jeng.retrieval.build_store(centers, members, jbank),
            t_build_store(centers, members, tbank))


def make_frames(n: int, seed: int = 3) -> list[dict]:
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n):
        frames.append(dict(
            image=rng.normal(size=(1, IMG, IMG, 3)).astype(np.float32),
            j2d=np.concatenate([rng.uniform(-1, 1, size=(1, 49, 2)),
                                np.ones((1, 49, 1))], -1).astype(np.float32),
            pose=rng.normal(scale=0.2, size=(1, 72)).astype(np.float32),
            betas=rng.normal(scale=0.3, size=(1, 10)).astype(np.float32),
            gender=np.asarray([i % 2], np.int32)))
    return frames


def jax_frame(fr: dict):
    return jeng.Frame(**{k: jnp.asarray(v) for k, v in fr.items()})


def torch_frame(fr: dict):
    return teng.Frame(**{k: torch.as_tensor(v) for k, v in fr.items()})


def port_params_as_flax(params: dict):
    """The port's parameter dict in the JAX package's param layout."""
    sd = {k: v.detach() for k, v in params.items()}
    return convert_torch_state_dict(sd, scan_blocks=False)[0]


def build_engines(cfg, jstore, tstore):
    """The JAX engine and the port's engine on the same weights, SMPL
    bodies, prior and store.  Build once per test module: the JAX step
    compiles once per engine (the threshold is a traced argument)."""
    jmodel, jparams = jax_hmr()
    jengine = jeng.BilevelEngine(cfg, jmodel, j_synthetic_gmm_prior(seed=4),
                                 jax_smpls(), jstore)
    tnet = torch_hmr_from(jparams)
    tengine = teng.BilevelEngine(cfg, tnet, t_prior(4, CPU), torch_smpls(),
                                 tstore)
    return dict(jengine=jengine, jparams=jparams, tengine=tengine,
                tparams={k: v.detach() for k, v in tnet.named_parameters()})


def run_both(engines, frames, thr=None):
    """Step both engines over the same frames from fresh states; every
    output comes back as numpy."""
    jengine, tengine = engines["jengine"], engines["tengine"]
    jstate = jengine.init_state(engines["jparams"], img_res=IMG)
    tstate = tengine.init_state(engines["tparams"], img_res=IMG)
    jouts, touts = [], []
    for fr in frames:
        jstate, o = jengine.step(jstate, jax_frame(fr), cos_sim_threshold=thr)
        jouts.append(jax.tree.map(np.asarray, o))
        tstate, o = tengine.step(tstate, torch_frame(fr), cos_sim_threshold=thr)
        touts.append(_to_numpy(o))
    return dict(jstate=jstate, jouts=jouts, tstate=tstate, touts=touts)


# -- assertions shared by the composed-step arms ------------------------------

LOSS_RTOL = 2e-3      # docs/PARITY.md: losses to rtol ~2e-3
LOSS_ATOL = 2e-5
# Metrics in mm.  Weights may differ by the Adam drift bound (below), whose
# metric effect docs/PARITY.md bounds far under 0.01 mm per frame.
METRIC_ATOL_MM = 1e-2
VERTS_ATOL_M = 1e-4   # vertices in metres, same reason


def adam_drift_bound(cfg, run) -> float:
    """docs/PARITY.md: each update may flip the sign of a near-zero-gradient
    coordinate's Adam step, so weights agree within n_updates * lr."""
    n_updates = sum(int(o["optim_steps"]) + 1 for o in run["jouts"])
    return n_updates * cfg.lr


def max_tree_diff(jtree, tparams) -> float:
    a = jax.tree.leaves(jtree)
    b = jax.tree.leaves(port_params_as_flax(tparams))
    assert len(a) == len(b)
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(a, b))


def assert_step_counts(run):
    j = [int(o["optim_steps"]) for o in run["jouts"]]
    t = [int(o["optim_steps"]) for o in run["touts"]]
    assert j == t, (j, t)


def assert_losses(run):
    for jo, to in zip(run["jouts"], run["touts"]):
        np.testing.assert_allclose(to["lower"]["loss"], jo["lower"]["loss"],
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL)
        np.testing.assert_allclose(to["upper"]["loss"], jo["upper"]["loss"],
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL)
        n = int(jo["optim_steps"]) + 1
        np.testing.assert_allclose(to["per_step_loss"][:n],
                                   jo["per_step_loss"][:n],
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL)
        for k in jo["upper"]:
            np.testing.assert_allclose(to["upper"][k], jo["upper"][k],
                                       rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                       err_msg=k)


def assert_metrics(run):
    for jo, to in zip(run["jouts"], run["touts"]):
        for k in ("mpjpe", "pampjpe", "pve", "lower_0_mpjpe",
                  "lower_0_pampjpe", "per_step_mpjpe", "per_step_pampjpe",
                  "per_step_pve"):
            np.testing.assert_allclose(to[k], jo[k], rtol=0,
                                       atol=METRIC_ATOL_MM, err_msg=k)
        np.testing.assert_allclose(to["verts"], jo["verts"], rtol=0,
                                   atol=VERTS_ATOL_M)


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    return x
