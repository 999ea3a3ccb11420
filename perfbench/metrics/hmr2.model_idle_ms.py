"""Device idle time per adapted frame (per ``step`` call) in the traced
segment that falls inside HMR 2.0's own forward: the gaps labelled
``model.backbone`` or ``model.head`` (``models/hmr2.py``), the host's
Python between the ViT's and the decoder's ATen calls in the eager
forwards (initial, probe, records, decode), in ms.  A gap whose innermost
operation is an ATen call keeps that call's name and is not read here."""

from perfbench.harness import spans


def read(r, cfg):
    return spans.idle_ms(r, names=("model.backbone", "model.head"))
