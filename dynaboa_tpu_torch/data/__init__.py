"""Data pipeline (counterpart of ``dynaboa_tpu.data``): streaming
datasets, source exemplars, offline preprocessing."""

from dynaboa_tpu_torch.data.streams import (
    InternetStream,
    PW3DStream,
    SyntheticStream,
    crop_and_normalize,
)

__all__ = ["PW3DStream", "InternetStream", "SyntheticStream",
           "crop_and_normalize"]
