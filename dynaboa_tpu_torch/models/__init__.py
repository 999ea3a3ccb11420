"""Model layer (counterpart of ``dynaboa_tpu.models``): the SMPL body
model and the HMR network."""

from dynaboa_tpu_torch.models.smpl import (
    SMPL_PARENTS,
    SMPLModel,
    SMPLOutput,
    lbs,
    load_smpl_npz,
    smpl_forward,
    synthetic_smpl_model,
)

__all__ = [
    "SMPLModel", "SMPLOutput", "smpl_forward", "lbs", "load_smpl_npz",
    "synthetic_smpl_model", "SMPL_PARENTS",
]
