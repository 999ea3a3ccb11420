"""Device idle time per adapted frame (per ``step`` call) in the traced
segment that falls inside CLIFF's own forward: the gaps labelled
``model.backbone``, ``model.fuse`` (an HRNet exchange unit) or
``model.head`` (``models/cliff.py``), the host's Python between the
trunk's and the regressor's ATen calls in the eager forwards (initial,
probe, records, decode), in ms.  A gap whose innermost operation is an
ATen call keeps that call's name and is not read here."""

from perfbench.harness import spans


def read(r, cfg):
    return spans.idle_ms(r, names=("model.backbone", "model.fuse",
                                   "model.head"))
