"""``engine_step``'s window over CLIFF: ``BilevelEngine.step`` per frame,
one stream, closed loop, with the check's copies of the state and the
traced segment after the window, all as ``entries/engine_step.py`` runs
them.  ``harness/program.py`` builds HMR only, so this file makes the
inputs (seeded CLIFF weights, the identity-pose mean, a store at CLIFF's
crop and feature width with a box per exemplar), builds the port's engine
around ``models/cliff.py:CLIFF`` and hands both to ``engine_step`` for the
run; the check's reference is ``reference/step_cliff.py``.

The frames are the ``boxed_crops`` source's dicts, whose ``box`` reaches
``Frame(**f)`` and the reference alike.  ``harness/check.py`` copies the
state's history ring without its boxes, so the check's copies here add the
ring's boxes (``hist_box``), and the reference's state takes them back.

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
from perfbench.harness import cliff as H
from perfbench.harness import inputs as I
from perfbench.harness.program import Inputs
from perfbench.harness.replay import part, tf32

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_base = found.module("entries", "engine_step", ROOT)
_Counted = found.module("entries", "hmr2_step", ROOT)._Counted
program_side = _base.program_side


def make_inputs(cfg: dict, seed: int, device) -> Inputs:
    m = cfg["model"]
    bodies, Jh36m = I.bodies(cfg["smpl"], seed, device)
    store = None
    if cfg["store"]:
        store = I.store(cfg["store"], m["feat_dim"], m["img_res"], seed,
                        device)
        store["box"] = H.store_boxes(cfg["store"], seed, device)
    return Inputs(weights=H.weights(m, seed, device),
                  init=I.mean_params(device), bodies=bodies, Jh36m=Jh36m,
                  store=store, gmm=I.gmm_arrays())


def build_system(cfg: dict, inp: Inputs, device, adapt_overrides=None):
    """``program.build_system`` with ``CLIFF`` in HMR's place; the model's
    weights are the inputs' own tensors (no second copy on the card)."""
    from dynaboa_tpu_torch.config import AdaptConfig
    from dynaboa_tpu_torch.engine.bilevel import BilevelEngine
    from dynaboa_tpu_torch.engine.retrieval import ExemplarBank, RetrievalStore
    from dynaboa_tpu_torch.losses.priors import load_gmm_prior
    from dynaboa_tpu_torch.metrics.eval import GenderedSMPL
    from dynaboa_tpu_torch.models.cliff import CLIFF
    from dynaboa_tpu_torch.models.smpl import SMPLModel

    acfg = AdaptConfig(**dict(cfg["adapt"], **(adapt_overrides or {})))
    with torch.device("meta"):
        model = CLIFF(**cfg["model"])
    state = dict(inp.weights, **dict(zip(
        ("init_pose", "init_shape", "init_cam"), inp.init)))
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
                              pose_3d=s["pose_3d"], box=s["box"]))
    engine = BilevelEngine(acfg, model, load_gmm_prior(I.GMM_FILE, device),
                           smpls, store, compute_metrics=cfg["compute_metrics"])
    params = {k: v.detach() for k, v in model.named_parameters()}
    return SimpleNamespace(cfg=acfg, device=torch.device(device), model=model,
                           params=params, engine=_Counted(engine),
                           smpls=smpls, store=store)


class _BoxCheck:
    """``harness/check.py`` with the history ring's boxes in each copy of
    the state."""

    def __getattr__(self, name):
        return getattr(check, name)

    @staticmethod
    def hist_like(state) -> dict:
        return dict(check.hist_like(state), hist_box=(
            tuple(state.hist_box.shape), state.hist_box.dtype))

    @staticmethod
    def snapshot(state, out: dict | None = None) -> dict:
        snap = check.snapshot(state, out)
        snap["hist_box"] = (out["hist_box"].copy_(state.hist_box)
                            if out and "hist_box" in out
                            else state.hist_box.clone())
        return snap


@contextlib.contextmanager
def _cliff_program(built: list):
    """``engine_step`` building this file's inputs and system, and copying
    the ring's boxes, while the block runs; ``built`` gets each system it
    builds."""
    def build(*a, **kw):
        built.append(build_system(*a, **kw))
        return built[-1]

    saved = _base.make_inputs, _base.build_system, _base.check
    _base.make_inputs, _base.build_system = make_inputs, build
    _base.check = _BoxCheck()
    try:
        yield
    finally:
        _base.make_inputs, _base.build_system, _base.check = saved


def drive(run) -> dict:
    built = []
    with _cliff_program(built):
        r = _base.drive(run)
    stats = built.pop().engine.stats
    W, n = run.mix["warmup_frames"], r["frames"]
    r["graph_stats"] = {"warmup": stats[W - 1], "window": stats[W + n - 1],
                        "trace": stats[-1]}
    print(f"graph_stats after the warm-up, the window and the traced "
          f"segment: {r['graph_stats']}", file=sys.stderr)
    return r


def reference_side(cfg: dict, chk: dict, device, control=False) -> dict:
    from perfbench.reference import step_cliff as RS
    from perfbench.reference.losses import gmm_prior

    inp = chk["inputs"]
    gmm = inp.gmm
    ctx = RS.Context(adapt=dict(cfg["adapt"]), model=cfg["model"],
                     init=inp.init, bodies=inp.bodies, Jh36m=inp.Jh36m,
                     prior=gmm_prior(gmm["means"], gmm["covars"],
                                     gmm["weights"], device),
                     store=inp.store, compute_metrics=cfg["compute_metrics"])
    w = inp.weights
    side = {"samples": {}}
    with tf32(control):
        st = RS.fresh_state(ctx, w, cfg["model"]["img_res"], device)
        recs = [RS.step(ctx, st, fr["frame"], chk["thr"], fr["cap"])
                for fr in chk["start_frames"]]
        side["start"] = part(recs, (st.params, st.teacher, st.m, st.v),
                             (w, w), recs[0]["grad_norms"])
        for s, (before, _, _, fr) in chk["samples"].items():
            st = RS.with_boxes(check.ref_state(before, ctx, device),
                               before["hist_box"].clone())
            rec = RS.step(ctx, st, fr["frame"], chk["thr"], fr["cap"])
            side["samples"][s] = part(rec, (st.params, st.teacher, st.m,
                                            st.v), check.split(before)[:2],
                                      rec["grad_norms"])
    return side
