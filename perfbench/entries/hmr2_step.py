"""``engine_step``'s window over HMR 2.0: ``BilevelEngine.step`` per frame,
one stream, closed loop, with the check's copies of the state and the
traced segment after the window, all as ``entries/engine_step.py`` runs
them.  ``harness/program.py`` builds HMR only, so this file makes the
inputs (seeded HMR 2.0 weights, its identity-pose mean, a store at its
crop and token width), builds the port's engine around
``models/hmr2.py:HMR2`` and hands both to ``engine_step`` for the run; the
check's reference is ``reference/step_hmr2.py``.

It also prints the engine's ``graph_stats`` (gradient evaluations run
eagerly, captured and replayed) after the warm-up, the window and the
traced segment, on standard error.
"""

from __future__ import annotations

import contextlib
import os
import sys
from types import SimpleNamespace

import torch

from perfbench.harness import check, found
from perfbench.harness import hmr2 as H
from perfbench.harness import inputs as I
from perfbench.harness.program import Inputs
from perfbench.harness.replay import part, tf32

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_base = found.module("entries", "engine_step", ROOT)
program_side = _base.program_side


def make_inputs(cfg: dict, seed: int, device) -> Inputs:
    m = cfg["model"]
    bodies, Jh36m = I.bodies(cfg["smpl"], seed, device)
    store = (I.store(cfg["store"], m["embed_dim"], m["img_res"], seed, device)
             if cfg["store"] else None)
    return Inputs(weights=H.weights(m, seed, device),
                  init=H.mean_params(device), bodies=bodies, Jh36m=Jh36m,
                  store=store, gmm=I.gmm_arrays())


class _Counted:
    """The engine, with its ``graph_stats`` copied after every step."""

    def __init__(self, engine):
        self.engine = engine
        self.stats = []

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def step(self, *a, **kw):
        out = self.engine.step(*a, **kw)
        self.stats.append(dict(self.engine.graph_stats))
        return out


def build_system(cfg: dict, inp: Inputs, device, adapt_overrides=None):
    """``program.build_system`` with ``HMR2`` in HMR's place; the model's
    weights are the inputs' own tensors (no second copy on the card)."""
    from dynaboa_tpu_torch.config import AdaptConfig
    from dynaboa_tpu_torch.engine.bilevel import BilevelEngine
    from dynaboa_tpu_torch.engine.retrieval import ExemplarBank, RetrievalStore
    from dynaboa_tpu_torch.losses.priors import load_gmm_prior
    from dynaboa_tpu_torch.metrics.eval import GenderedSMPL
    from dynaboa_tpu_torch.models.hmr2 import HMR2
    from dynaboa_tpu_torch.models.smpl import SMPLModel

    acfg = AdaptConfig(**dict(cfg["adapt"], **(adapt_overrides or {})))
    with torch.device("meta"):
        model = HMR2(**cfg["model"])
    head = "smpl_head."
    state = dict(inp.weights, **{head + k: v for k, v in zip(
        ("init_body_pose", "init_betas", "init_cam"), inp.init)})
    model.load_state_dict(state, assign=True)

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
    engine = BilevelEngine(acfg, model, load_gmm_prior(I.GMM_FILE, device),
                           smpls, store, compute_metrics=cfg["compute_metrics"])
    params = {k: v.detach() for k, v in model.named_parameters()}
    return SimpleNamespace(cfg=acfg, device=torch.device(device), model=model,
                           params=params, engine=_Counted(engine),
                           smpls=smpls, store=store)


@contextlib.contextmanager
def _hmr2_program(built: list):
    """``engine_step`` building this file's inputs and system while the
    block runs; ``built`` gets each system it builds."""
    def build(*a, **kw):
        built.append(build_system(*a, **kw))
        return built[-1]

    saved = _base.make_inputs, _base.build_system
    _base.make_inputs, _base.build_system = make_inputs, build
    try:
        yield
    finally:
        _base.make_inputs, _base.build_system = saved


def drive(run) -> dict:
    built = []
    with _hmr2_program(built):
        r = _base.drive(run)
    stats = built.pop().engine.stats
    W, n = run.mix["warmup_frames"], r["frames"]
    r["graph_stats"] = {"warmup": stats[W - 1], "window": stats[W + n - 1],
                        "trace": stats[-1]}
    print(f"graph_stats after the warm-up, the window and the traced "
          f"segment: {r['graph_stats']}", file=sys.stderr)
    return r


def reference_side(cfg: dict, chk: dict, device, control=False) -> dict:
    from perfbench.reference import step as RS
    from perfbench.reference import step_hmr2 as RS2
    from perfbench.reference.losses import gmm_prior

    inp = chk["inputs"]
    gmm = inp.gmm
    ctx = RS2.Context(adapt=dict(cfg["adapt"]), model=cfg["model"],
                      init=inp.init, bodies=inp.bodies, Jh36m=inp.Jh36m,
                      prior=gmm_prior(gmm["means"], gmm["covars"],
                                      gmm["weights"], device),
                      store=inp.store, compute_metrics=cfg["compute_metrics"])
    w = inp.weights
    side = {"samples": {}}
    with tf32(control):
        st = RS.fresh_state(ctx, w, cfg["model"]["img_res"], device)
        recs = [RS2.step(ctx, st, fr["frame"], chk["thr"], fr["cap"])
                for fr in chk["start_frames"]]
        side["start"] = part(recs, (st.params, st.teacher, st.m, st.v),
                             (w, w), recs[0]["grad_norms"])
        for s, (before, _, _, fr) in chk["samples"].items():
            st = check.ref_state(before, ctx, device)
            rec = RS2.step(ctx, st, fr["frame"], chk["thr"], fr["cap"])
            side["samples"][s] = part(rec, (st.params, st.teacher, st.m,
                                            st.v), check.split(before)[:2],
                                      rec["grad_norms"])
    return side
