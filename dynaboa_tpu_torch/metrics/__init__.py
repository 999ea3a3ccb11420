"""Evaluation metrics and the scalar writer (counterpart of
``dynaboa_tpu.metrics``)."""

from dynaboa_tpu_torch.metrics.eval import (GenderedSMPL, evaluate_frame,
                                            h36m_14_joints)

__all__ = ["GenderedSMPL", "evaluate_frame", "h36m_14_joints"]
