"""Adaptation engine (counterpart of ``dynaboa_tpu.engine``): the
dynamic-bilevel step, retrieval, checkpoints and the stream runner."""

from dynaboa_tpu_torch.engine.bilevel import AdaptState, BilevelEngine, Frame
from dynaboa_tpu_torch.engine.retrieval import (
    ExemplarBank,
    RetrievalStore,
    build_store,
    retrieve,
    synthetic_store,
)

__all__ = [
    "AdaptState", "BilevelEngine", "Frame", "ExemplarBank", "RetrievalStore",
    "retrieve", "build_store", "synthetic_store",
]
