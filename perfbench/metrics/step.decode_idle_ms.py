"""Device idle time per adapted frame (per ``step`` call) in the traced
segment that falls in the step's decodes and records: the gaps labelled
``step.decode`` (the final decode, feature similarity, metrics and the
history write), ``step.record`` (the lower-level and per-update records)
or ``step.targets`` (the ground truth's decode), in ms."""

from perfbench.harness import spans


def read(r, cfg):
    return spans.idle_ms(r, names=("step.decode", "step.record",
                                   "step.targets"))
