"""Device idle time per adapted frame (per ``step`` call) in the traced
segment that falls in the step's gradient evaluations: the gaps labelled
``step.grad.lower`` or ``step.grad.upper`` (each level's batched forward,
teacher forward, losses and ``autograd.grad``), in ms."""

from perfbench.harness import spans


def read(r, cfg):
    return spans.idle_ms(r, prefixes=("step.grad.",))
