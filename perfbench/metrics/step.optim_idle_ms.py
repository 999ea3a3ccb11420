"""Device idle time per adapted frame (per ``step`` call) in the traced
segment that falls in the outer update: the gaps labelled ``step.optim``
(the gradients handed to Adam, Adam and the teacher EMA) or with torch's
own ``Optimizer.*`` spans inside it, in ms."""

from perfbench.harness import spans


def read(r, cfg):
    return spans.idle_ms(r, names=("step.optim",), prefixes=("Optimizer.",))
