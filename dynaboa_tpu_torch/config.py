"""Adaptation hyperparameters and dataset paths, as frozen dataclasses.

The port's own copy of ``AdaptConfig`` and ``Paths`` from
``dynaboa_tpu/config.py``, so that no module of the port imports the JAX
package.  Field names and defaults are the same (``tests/
test_torch_standalone.py`` holds them equal), and code of the port that takes
a config reads it by attribute, so it also accepts the JAX package's classes.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass


@dataclass(frozen=True)
class AdaptConfig:
    """Dynamic bilevel online adaptation hyperparameters.

    Defaults are the reference's 3DPW benchmark defaults
    (dynaboa_benchmark.py:16-65).
    """

    # outer (upper-level) Adam
    lr: float = 3e-6
    beta1: float = 0.5
    beta2: float = 0.9

    # bilevel structure
    use_boa: bool = True
    fastlr: float = 8e-6          # inner SGD learning rate
    inner_step: int = 1
    record_lowerlevel: bool = True

    # frame-loss weights
    s2dloss_weight: float = 10.0
    shape_prior_weight: float = 2e-6
    pose_prior_weight: float = 1e-4

    # which loss groups run at which level
    use_frame_losses_lower: bool = True
    use_frame_losses_upper: bool = True
    use_temporal_losses_lower: bool = False
    use_temporal_losses_upper: bool = True

    # retrieval / mixed training
    retrieval: bool = True
    sample_num: int = 1
    lower_level_mixtrain: bool = True
    upper_level_mixtrain: bool = True
    labelloss_weight: float = 0.1

    # dynamic extra steps
    dynamic_boa: bool = True
    cos_sim_threshold: float = 3.1e-4
    optim_steps: int = 7
    # per-extra-step metric records (MPJPE/PA-MPJPE/PVE after every dynamic
    # update); the sim and loss trajectories are always recorded
    record_dynamic: bool = True

    # mean teacher
    use_meanteacher: bool = True
    alpha: float = 0.1            # teacher = alpha * teacher + (1-alpha) * student
    teacherloss_weight: float = 0.1

    # temporal motion loss
    use_motion: bool = True
    interval: int = 5
    motionloss_weight: float = 0.8

    seed: int = 22

    # the hand-written skinning kernel for the no-grad SMPL decodes (final
    # prediction / metrics); the in-loss decode stays on the eager autograd
    # path (the kernel has no backward).  The name is the JAX package's.
    use_pallas_lbs: bool = False

    # backbone compute precision; the port runs "float32" only
    compute_dtype: str = "float32"

    # keypoint source for the 2D losses: 'gt' uses joints [25:] (benchmark /
    # internet paths), 'openpose' uses joints [:25] (webcam path)
    keypoint_source: str = "gt"

    # worst-case latency experiments of the JAX package (documented protocol
    # divergences, off by default); the port's engine refuses them
    fast_extra_updates: bool = False
    probe_res_factor: int = 1

    def replace(self, **kw) -> "AdaptConfig":
        return dataclasses.replace(self, **kw)

    @property
    def mixtrain(self) -> bool:
        return self.lower_level_mixtrain or self.upper_level_mixtrain

    # internet-video preset (reference run_on_internet.sh:1-9)
    @classmethod
    def internet(cls) -> "AdaptConfig":
        return cls(shape_prior_weight=2e-4)


@dataclass(frozen=True)
class Paths:
    """Dataset roots and asset paths (reference config.py:7-17)."""

    pw3d_root: str = os.environ.get("PW3D_ROOT", "/data/3dpw")
    h36m_root: str = os.environ.get("H36M_ROOT", "/data/h36m")
    internet_root: str = os.environ.get("INTERNET_ROOT", "supp_assets/internet")
    dataset_npz_path: str = "data/dataset_extras"
    retrieval_res: str = "data/retrieval_res"
    smpl_model_dir: str = os.environ.get("SMPL_MODEL_DIR", "data/smpl_npz")
    smpl_mean_params: str = "data/smpl_mean_params.npz"
    joint_regressor_h36m: str = "data/J_regressor_h36m.npy"
    joint_regressor_extra: str = "data/J_regressor_extra.npy"
    basemodel: str = "data/basemodel.pt"
    gmm_prior: str | None = None  # None -> shipped asset / data dirs
