"""The system under test, built through the port's own constructors from
the inputs the benchmark made (``inputs.py``), and the reference's context
built from the same inputs.  Nothing here reads a file of the port's assets
or draws a number the benchmark did not draw."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from perfbench.harness import inputs as I


class Inputs(SimpleNamespace):
    """weights, init (mean params), bodies, Jh36m, store, gmm."""


def make_inputs(cfg: dict, seed: int, device) -> Inputs:
    model = cfg["model"]
    bodies, Jh36m = I.bodies(cfg["smpl"], seed, device)
    store = None
    if cfg["store"]:
        feat = model["width"] * 8 * 4
        store = I.store(cfg["store"], feat, model["img_res"], seed, device)
    return Inputs(weights=I.hmr_weights(model, seed, device),
                  init=I.mean_params(device), bodies=bodies, Jh36m=Jh36m,
                  store=store, gmm=I.gmm_arrays())


def build_system(cfg: dict, inp: Inputs, device, adapt_overrides=None):
    """The port's engine over ``inp``: ``AdaptConfig`` from the
    configuration, ``HMR`` with the benchmark's weights, ``SMPLModel``
    bodies, the GMM prior through ``load_gmm_prior`` and the store as an
    ``ExemplarBank`` in a ``RetrievalStore``."""
    from dynaboa_tpu_torch.config import AdaptConfig
    from dynaboa_tpu_torch.engine.bilevel import BilevelEngine
    from dynaboa_tpu_torch.engine.retrieval import ExemplarBank, RetrievalStore
    from dynaboa_tpu_torch.losses.priors import load_gmm_prior
    from dynaboa_tpu_torch.metrics.eval import GenderedSMPL
    from dynaboa_tpu_torch.models.hmr import HMR
    from dynaboa_tpu_torch.models.smpl import SMPLModel

    adapt = dict(cfg["adapt"], **(adapt_overrides or {}))
    acfg = AdaptConfig(**adapt)
    m = cfg["model"]
    with torch.device("meta"):
        model = HMR(layers=tuple(m["layers"]), width=m["width"],
                    regressor_dim=m["regressor_dim"], n_iter=m["n_iter"],
                    compute_dtype=acfg.compute_dtype)
    model = model.to_empty(device=device)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(inp.weights[k])
        for buf, v in zip(("init_pose", "init_shape", "init_cam"), inp.init):
            getattr(model, buf).copy_(v)

    def smpl(b):
        return SMPLModel(
            v_template=b["v_template"], shapedirs=b["shapedirs"],
            posedirs=b["posedirs"], J_regressor=b["J_regressor"],
            lbs_weights=b["lbs_weights"], parents=tuple(b["parents"]),
            faces=b["faces"], J_regressor_extra=b["J_regressor_extra"],
            vertex_joint_ids=b["vertex_joint_ids"].long())

    smpls = GenderedSMPL(neutral=smpl(inp.bodies["neutral"]),
                         male=smpl(inp.bodies["male"]),
                         female=smpl(inp.bodies["female"]),
                         J_regressor_h36m=inp.Jh36m)
    store = None
    if inp.store is not None:
        s = inp.store
        store = RetrievalStore(
            centers=s["centers"], members=s["members"],
            member_mask=s["member_mask"],
            bank=ExemplarBank(images=s["images"], keypoints=s["keypoints"],
                              pose=s["pose"], betas=s["betas"],
                              pose_3d=s["pose_3d"]))
    prior = load_gmm_prior(I.GMM_FILE, device)
    engine = BilevelEngine(acfg, model, prior, smpls, store,
                           compute_metrics=cfg["compute_metrics"])
    params = {k: v.detach() for k, v in model.named_parameters()}
    return SimpleNamespace(cfg=acfg, device=torch.device(device), model=model,
                           params=params, engine=engine, smpls=smpls,
                           store=store)


def reference_context(cfg: dict, inp: Inputs, device):
    from perfbench.reference.losses import gmm_prior
    from perfbench.reference.step import Context

    m = cfg["model"]
    return Context(adapt=dict(cfg["adapt"]), layers=tuple(m["layers"]),
                   n_iter=m["n_iter"], init=inp.init, bodies=inp.bodies,
                   Jh36m=inp.Jh36m,
                   prior=gmm_prior(inp.gmm["means"], inp.gmm["covars"],
                                   inp.gmm["weights"], device),
                   store=inp.store, compute_metrics=cfg["compute_metrics"])
