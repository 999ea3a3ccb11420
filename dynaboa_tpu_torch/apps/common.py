"""System assembly: model, SMPL bodies, prior and retrieval store wired into
a ``BilevelEngine`` on one device (counterpart of
``dynaboa_tpu/apps/common.py``).  Every license-gated asset is used when it
exists and replaced by the same deterministic synthetic stand-in as the JAX
package's when it does not."""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from dynaboa_tpu import constants
from dynaboa_tpu.config import AdaptConfig, Paths
from dynaboa_tpu_torch.engine.bilevel import BilevelEngine
from dynaboa_tpu_torch.engine.retrieval import RetrievalStore, synthetic_store
from dynaboa_tpu_torch.losses.priors import (default_gmm_path, load_gmm_prior,
                                             synthetic_gmm_prior)
from dynaboa_tpu_torch.metrics.eval import GenderedSMPL
from dynaboa_tpu_torch.models.hmr import HMR, hmr, init_weights_, load_basemodel
from dynaboa_tpu_torch.models.smpl import load_smpl_npz, synthetic_smpl_model


@dataclass
class System:
    cfg: AdaptConfig
    paths: Paths
    device: torch.device
    model: HMR
    params: dict
    engine: BilevelEngine
    smpls: GenderedSMPL
    store: RetrievalStore | None
    synthetic: dict


def build_smpls(paths: Paths, device, num_vertices: int | None = None
                ) -> tuple[GenderedSMPL, bool]:
    d = paths.smpl_model_dir
    names = {g: os.path.join(d, f"smpl_{g}.npz")
             for g in ("neutral", "male", "female")}
    have_models = all(os.path.exists(p) for p in names.values())
    have_jreg = os.path.exists(paths.joint_regressor_h36m)
    if have_models:
        neutral, male, female = (load_smpl_npz(names[g], device)
                                 for g in ("neutral", "male", "female"))
        V = neutral.v_template.shape[0]
    else:
        V = num_vertices or constants.NUM_VERTICES
        neutral = synthetic_smpl_model(10, device, num_vertices=V)
        male = synthetic_smpl_model(11, device, num_vertices=V)
        female = synthetic_smpl_model(12, device, num_vertices=V)
    if have_jreg:
        Jh36m = np.load(paths.joint_regressor_h36m)
    else:
        Jh36m = np.random.default_rng(5).dirichlet(np.ones(V), size=17)
    Jh36m = torch.as_tensor(np.asarray(Jh36m, np.float32), device=device)
    return (GenderedSMPL(neutral=neutral, male=male, female=female,
                         J_regressor_h36m=Jh36m),
            have_models and have_jreg)


def build_system(cfg: AdaptConfig, paths: Paths | None, device,
                 img_res: int = constants.IMG_RES,
                 model_kwargs: dict | None = None,
                 num_vertices: int | None = None) -> System:
    """``model_kwargs``/``num_vertices`` shrink the network and body model
    (smoke mode; real checkpoints need the full defaults)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device "
                               "is available")
        # fp32 means fp32: cuDNN convolutions default to TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    paths = paths or Paths()
    synthetic: dict[str, bool] = {}

    if os.path.exists(paths.basemodel) and not model_kwargs:
        model = load_basemodel(paths.basemodel, device)
        synthetic["weights"] = False
    else:
        mean = (paths.smpl_mean_params
                if os.path.exists(paths.smpl_mean_params) else None)
        model = hmr(mean, **(model_kwargs or {}))
        # weights drawn on the CPU from a seeded generator, so every device
        # starts from the same numbers
        init_weights_(model, torch.Generator().manual_seed(cfg.seed))
        model = model.to(device)
        synthetic["weights"] = True
    params = {k: v.detach() for k, v in model.named_parameters()}

    smpls, real = build_smpls(paths, device, num_vertices=num_vertices)
    synthetic["smpl"] = not real

    gmm_path = paths.gmm_prior or default_gmm_path()
    if gmm_path:
        prior = load_gmm_prior(gmm_path, device)
        synthetic["prior"] = False
    else:
        prior = synthetic_gmm_prior(cfg.seed, device)
        synthetic["prior"] = True

    store = None
    if cfg.mixtrain or cfg.retrieval:
        cluster_file = os.path.join(
            paths.retrieval_res,
            "cluster_res_random_sample_center_10_10_potocol2.pt")
        if os.path.exists(cluster_file) and not model_kwargs:
            raise NotImplementedError(
                "the reference retrieval store (H36M exemplars) is not "
                "ported; remove data/retrieval_res to use the synthetic store")
        width = (model_kwargs or {}).get("width", 64)
        store = synthetic_store(cfg.seed, device, img_res=img_res,
                                feat_dim=width * 8 * 4)
        synthetic["retrieval"] = True

    engine = BilevelEngine(cfg, model, prior, smpls, store)
    return System(cfg=cfg, paths=paths, device=device, model=model,
                  params=params, engine=engine, smpls=smpls, store=store,
                  synthetic=synthetic)
