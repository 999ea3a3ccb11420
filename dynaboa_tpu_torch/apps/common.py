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

from dynaboa_tpu_torch import constants
from dynaboa_tpu_torch.config import AdaptConfig, Paths
from dynaboa_tpu_torch.engine.bilevel import BilevelEngine
from dynaboa_tpu_torch.engine.retrieval import (RetrievalStore,
                                                load_reference_store,
                                                synthetic_store)
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
                 compute_metrics: bool = True,
                 img_res: int = constants.IMG_RES,
                 model_kwargs: dict | None = None,
                 num_vertices: int | None = None) -> System:
    """``model_kwargs``/``num_vertices`` shrink the network and body model
    (smoke mode; real checkpoints need the full defaults).
    ``compute_metrics=False`` is for unlabeled streams (see
    ``BilevelEngine``).  ``cfg.compute_dtype`` sets the backbone's
    precision (``models/hmr.py``)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device "
                               "is available")
        if cfg.compute_dtype == "bfloat16" and \
                not torch.cuda.is_bf16_supported():
            raise RuntimeError("compute_dtype='bfloat16' requested but the "
                               "CUDA device does not support bfloat16")
        # fp32 means fp32: cuDNN convolutions default to TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    paths = paths or Paths()
    synthetic: dict[str, bool] = {}

    if os.path.exists(paths.basemodel) and not model_kwargs:
        model = load_basemodel(paths.basemodel, device, cfg.compute_dtype)
        synthetic["weights"] = False
    else:
        mean = (paths.smpl_mean_params
                if os.path.exists(paths.smpl_mean_params) else None)
        model = hmr(mean, compute_dtype=cfg.compute_dtype,
                    **(model_kwargs or {}))
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
        source_file = os.path.join(
            paths.retrieval_res, "h36m_random_sample_center_10_10.pt")
        if (os.path.exists(cluster_file) and os.path.exists(source_file)
                and not model_kwargs):
            store = load_reference_store(paths.retrieval_res, source_file,
                                         paths.h36m_root, device)
            synthetic["retrieval"] = False
        else:
            width = (model_kwargs or {}).get("width", 64)
            store = synthetic_store(cfg.seed, device, img_res=img_res,
                                    feat_dim=width * 8 * 4)
            synthetic["retrieval"] = True

    engine = BilevelEngine(cfg, model, prior, smpls, store,
                           compute_metrics=compute_metrics)
    return System(cfg=cfg, paths=paths, device=device, model=model,
                  params=params, engine=engine, smpls=smpls, store=store,
                  synthetic=synthetic)


def write_settings(exppath: str, args) -> None:
    """setting.txt: every CLI argument, sorted."""
    os.makedirs(exppath, exist_ok=True)
    with open(os.path.join(exppath, "setting.txt"), "w") as f:
        f.write("------------------ start ------------------\n")
        for k, v in sorted(vars(args).items()):
            f.write(f"{k} : {v}\n")
        f.write("------------------- end -------------------")
