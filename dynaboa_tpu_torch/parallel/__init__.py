"""Independent adaptation streams over CUDA devices (counterpart of
``dynaboa_tpu.parallel``)."""

from dynaboa_tpu_torch.parallel.streams import (
    ParallelStreams,
    make_mesh,
    stack_frames,
    stack_outs,
)

__all__ = ["ParallelStreams", "make_mesh", "stack_frames", "stack_outs"]
