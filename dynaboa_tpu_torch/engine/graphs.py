"""CUDA graphs of ``BilevelEngine.step``'s gradient evaluations.

One evaluation (``BilevelEngine._value_and_grad``: the batched forward, the
teacher's forward, the losses and ``torch.autograd.grad``) launches some
2,500 kernels whose shapes are fixed once the configuration is; dispatched
from Python one by one they hold the card idle for most of the evaluation.
On a card, each ``AdaptState`` captures an evaluation once per key and
replays it after (``GradGraphs.evaluate``):

* the engine runs each key's first call eagerly, once per engine: the
  warm-up that lazy library set-up (cuDNN plans, cuBLAS workspaces) needs
  before a capture.  After it, a state's first call of the key captures;
* before every replay, what changes from call to call (the frame's image,
  keypoints and mask, the history slot, the motion loss's on-switch, the
  exemplar rows) is copied into buffers the graph owns, in one launch.  The
  weights are bound where they live: Adam, the teacher's EMA and the inner
  update write them in place.  A state whose weights were replaced (another
  storage) captures anew;
* the loss and its terms leave the graph in one small copy.  The features
  and the gradients stay the graph's: the next replay of any of the state's
  graphs may overwrite them, so the step consumes them before it.

The graphs of one state share one memory pool and are freed with the state.
"""

from __future__ import annotations

import time

import torch

from dynaboa_tpu_torch.tracing import span


def new_stats() -> dict:
    """Counters of gradient evaluations by how they ran: ``eager`` (the
    CPU, bfloat16, a key's warm-up call), ``captures`` (a capture and its
    first replay), ``replays``, and ``capture_ms``, the host time of the
    captures."""
    return {"eager": 0, "captures": 0, "replays": 0, "capture_ms": 0.0}


def _leaves(x) -> list:
    """The tensors of ``x`` (a tensor, None, or a tuple of them, nested) in
    order."""
    if x is None:
        return []
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for y in x for t in _leaves(y)]


def _buffers_like(x):
    """Empty tensors laid out like those of ``x`` (a tensor, None, or a
    NamedTuple of them), in its structure."""
    if x is None or isinstance(x, torch.Tensor):
        return None if x is None else torch.empty_like(x)
    return type(x)(*map(_buffers_like, x))


class _Graph:
    """One captured evaluation: its graph, the buffers it reads and writes,
    and the storage of the weights it was captured on."""

    def __init__(self, inputs, binding: tuple):
        self.inputs = tuple(map(_buffers_like, inputs))
        self.buffers = _leaves(self.inputs)
        self.binding = binding
        self.graph = None
        self.out = None

    def load(self, inputs) -> None:
        torch._foreach_copy_(self.buffers, _leaves(inputs))

    def capture(self, fn, pool) -> None:
        """Capture ``fn`` on the buffers into ``pool``, on a side stream of
        their card; ``out`` holds its outputs, the loss and terms stacked
        into one vector.  (``torch.cuda.graph`` would also synchronize the
        card and empty the allocator's caches before each capture; here the
        caches are emptied once a state, ``GradGraphs._capture``.)

        cuBLAS keeps a workspace per stream for the life of the process.
        One first made inside the capture comes from ``pool`` and would keep
        the pool, and every graph of the state, alive after the state is
        dropped; one made before it would be memory the graph does not own.
        So the workspaces are dropped before and after each capture, as
        PyTorch's own graph trees do: the capture makes its own in ``pool``,
        and it is freed with the pool."""
        with torch.cuda.device(self.buffers[0].device):
            self.graph = torch.cuda.CUDAGraph()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            torch._C._cuda_clearCublasWorkspaces()
            with torch.cuda.stream(side):
                # thread_local: the stream app's render worker waits on its
                # copies' events and frees pinned buffers meanwhile
                self.graph.capture_begin(pool,
                                         capture_error_mode="thread_local")
                try:
                    loss, feats, aux, grads = fn(*self.inputs)
                    self.out = (torch.stack([loss, *aux.values()]),
                                list(aux), feats, grads)
                finally:
                    self.graph.capture_end()
                    torch._C._cuda_clearCublasWorkspaces()
            torch.cuda.current_stream().wait_stream(side)

    def replay(self) -> None:
        self.graph.replay()

    def results(self):
        """``(loss, feats, aux, grads)``: the loss and the terms copied out
        of the graph, the features and gradients its own."""
        vec, names, feats, grads = self.out
        vec = vec.clone()
        return vec[0], feats, dict(zip(names, vec[1:].unbind())), grads


class GradGraphs:
    """The captured gradient evaluations of one ``AdaptState``, by key."""

    def __init__(self):
        self._graphs: dict = {}
        self._pool = None

    def evaluate(self, key, warm: set, stats: dict, fn, inputs, bound):
        """``fn(*inputs)``, the eager evaluation ``(loss, feats, aux,
        grads)``, or its graph.  ``key`` names the evaluation's kind and
        shapes (``BilevelEngine._grad_key``); ``warm`` holds the keys the
        engine has run eagerly; ``bound`` lists the weight tensors the
        evaluation reads where they live."""
        if key not in warm:
            warm.add(key)
            stats["eager"] += 1
            return fn(*inputs)
        binding = tuple(map(torch.Tensor.data_ptr, bound))
        g = self._graphs.get(key)
        if g is None or g.binding != binding:
            with span("step.grad.capture"):
                t0 = time.perf_counter()
                g = self._graphs[key] = self._capture(fn, inputs, binding)
                stats["capture_ms"] += 1e3 * (time.perf_counter() - t0)
                stats["captures"] += 1
                return g.results()
        with span("step.grad.replay"):
            g.load(inputs)
            g.replay()
            stats["replays"] += 1
            return g.results()

    def _capture(self, fn, inputs, binding) -> _Graph:
        g = _Graph(inputs, binding)
        g.load(inputs)
        if self._pool is None:
            # a dropped state's pool returns to the card only through
            # empty_cache, and an allocation that fails inside a capture
            # cannot call it: so a new state's first capture calls it
            torch.cuda.empty_cache()
            self._pool = torch.cuda.graph_pool_handle()
        g.capture(fn, self._pool)
        g.replay()
        return g
