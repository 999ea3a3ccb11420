"""Hand-written CUDA kernels for the SMPL layer (counterpart of
``dynaboa_tpu.kernels``): ``LBSKernelSMPL`` and ``skin`` stand where
``PallasSMPL`` and ``skinning_kernel_call`` do.  Importing builds nothing:
the kernel library is built at the first CUDA launch."""

from dynaboa_tpu_torch.kernels.lbs import LBSKernelSMPL, skin

__all__ = ["LBSKernelSMPL", "skin"]
