"""Device idle time per adapted frame (per ``step`` call) in the traced
segment that falls in the update gate: the gaps labelled ``step.probe``
(the post-update forward and its cosine) or ``step.gate_read`` (the host's
read of the gate), in ms."""

from perfbench.harness import spans


def read(r, cfg):
    return spans.idle_ms(r, names=("step.probe", "step.gate_read"))
