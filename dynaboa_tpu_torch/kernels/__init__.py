"""Hand-written CUDA kernels: the SMPL layer's skinning (counterpart of
``dynaboa_tpu.kernels``: ``LBSKernelSMPL`` and ``skin`` stand where
``PallasSMPL`` and ``skinning_kernel_call`` do) and HMR's GroupNorm
(``kernels/group_norm.py``, which replaces no TPU kernel).  Importing builds
nothing: each kernel library is built at its first CUDA launch."""

from dynaboa_tpu_torch.kernels.lbs import LBSKernelSMPL, skin

__all__ = ["LBSKernelSMPL", "skin"]
