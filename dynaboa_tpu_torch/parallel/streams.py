"""Independent adaptation streams over one or several CUDA devices
(counterpart of ``dynaboa_tpu/parallel/streams.py``).

The frames of one stream are sequential: each frame's adaptation changes the
weights the next frame starts from.  The scale-out axis is therefore across
independent (seq, person) streams (3DPW has 37), each with private weights,
Adam state, teacher and history ring.

- **Independent streams** (the default): stream s lives on
  ``devices[s % D]``.  The engine's assets (the HMR module, SMPL bodies,
  prior, retrieval store and the skinning kernel's tile-major layout) are
  placed once per device: ``ParallelStreams`` builds one engine per device at
  the first use of that device, never one per step.
- **``share_weights=True``**: every stream steps from its own state, then the
  params of all S streams are averaged on ``devices[0]`` and written back
  into every stream's params in place.  Adam and the teacher stay private,
  as in the JAX package, whose ``pmean`` replaces only the params.  One
  process drives every device, so no process group is needed.

Random numbers: stream s draws its exemplars from a ``torch.Generator``
seeded with ``stream_seed(cfg.seed, s)``, the first 32-bit word of numpy's
``SeedSequence((cfg.seed, s))``.  The JAX package splits ``PRNGKey(seed)``
instead, so the draws differ (docs/PARITY.md divergence 2).

``run_parallel`` steps the streams round robin: one host thread steps
stream 0, 1, ..., S - 1 in turn, one frame each.  The step reads the gate's
cosine on the host once per update, so no stream's host work overlaps
another's device work.  A host thread per stream, each on its own CUDA
stream, measured slower on the H100 (root PERF.md) and was not kept.  A
stream's results do not depend on the streams beside it.
"""

from __future__ import annotations

import collections
import copy
import time
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from dynaboa_tpu_torch.engine.bilevel import BilevelEngine, Frame
from dynaboa_tpu_torch.engine.checkpoint import malloc_trim
from dynaboa_tpu_torch.engine.runner import frame_from_item

METRIC_KEYS = ("mpjpe", "pampjpe", "pve")
# per stream: frames of metrics fetched to the host at once (and a heap
# trim after each fetch), and items loaded ahead on the pool
FLUSH = 64
PREFETCH = 3


def make_mesh(n_devices: int | None = None) -> list[torch.device]:
    """The first ``n_devices`` CUDA devices (all of them by default)."""
    n_avail = torch.cuda.device_count()
    if n_devices is None:
        n_devices = n_avail
    if not 1 <= n_devices <= n_avail:
        # silent clamping would mis-attribute a benchmark's device count
        raise ValueError(f"n_devices={n_devices} but {n_avail} CUDA "
                         "device(s) are available")
    return [torch.device("cuda", i) for i in range(n_devices)]


def stream_seed(seed: int, s: int) -> int:
    """The seed of stream ``s``'s generator (see the module docstring)."""
    return int(np.random.SeedSequence((seed, s)).generate_state(1)[0])


def _canonical(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _to(x, dev):
    """Tensors of a (nested) NamedTuple moved to ``dev``; other fields (SMPL
    parents, faces) are kept as they are."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(type(x), "_fields"):
        return type(x)(*[_to(v, dev) for v in x])
    return x


def _engine_on(engine: BilevelEngine, dev: torch.device) -> BilevelEngine:
    """A copy of ``engine`` whose module and assets live on ``dev``."""
    return BilevelEngine(engine.cfg, copy.deepcopy(engine.model).to(dev),
                         _to(engine.prior, dev), _to(engine.smpls, dev),
                         _to(engine.store, dev),
                         compute_metrics=engine.compute_metrics)


class ParallelStreams:
    """S adaptation streams over ``devices``.

    ``init_states`` returns a list of per-stream ``AdaptState``s, stream s
    on ``devices[s % D]``; ``step`` advances every stream by one frame and
    returns (the same list, updated in place; a list of per-stream output
    dicts, on their devices).  Use :func:`stack_outs` to bring the outputs
    to the host.
    """

    def __init__(self, engine: BilevelEngine, devices,
                 share_weights: bool = False):
        self.engine = engine
        self.devices = [_canonical(d) for d in devices]
        if not self.devices:
            raise ValueError("ParallelStreams needs at least one device")
        self.share_weights = share_weights
        self._engines = {engine.device: engine}

    def engine_for(self, dev: torch.device) -> BilevelEngine:
        """The engine of ``dev``, built at its first use."""
        eng = self._engines.get(dev)
        if eng is None:
            eng = self._engines[dev] = _engine_on(self.engine, dev)
        return eng

    def device_of(self, s: int) -> torch.device:
        return self.devices[s % len(self.devices)]

    def init_states(self, params: dict, num_streams: int, img_res: int = 224,
                    batch_size: int = 1) -> list:
        """Fresh per-stream states, each with private copies of ``params``
        and its own generator."""
        S, D = num_streams, len(self.devices)
        if self.share_weights and S % D:
            raise ValueError(f"num_streams={S} must be divisible by the "
                             f"device count {D}")
        states = []
        for s in range(S):
            st = self.engine_for(self.device_of(s)).init_state(
                params, batch_size=batch_size, img_res=img_res)
            st.rng.manual_seed(stream_seed(self.engine.cfg.seed, s))
            states.append(st)
        return states

    def step(self, states: list, frames):
        """Advance every stream by one frame.  ``frames`` is a list of S
        ``Frame``s; each goes to its stream's device.  Under
        ``share_weights`` the params are then averaged."""
        outs = []
        for s, (state, frame) in enumerate(zip(states, frames, strict=True)):
            dev = self.device_of(s)
            frame = Frame(*[None if v is None else v.to(dev) for v in frame])
            states[s], out = self.engine_for(dev).step(state, frame)
            outs.append(out)
        if self.share_weights:
            self._average_params(states)
        return states, outs

    @torch.no_grad()
    def _average_params(self, states: list) -> None:
        dev0 = self.devices[0]
        for k in states[0].params:
            mean = torch.stack([st.params[k].to(dev0) for st in states]).mean(0)
            for st in states:
                st.params[k].copy_(mean)


def stack_frames(items: list[dict], device,
                 keypoint_source: str = "gt") -> Frame:
    """One item from each of S streams as one Frame with a leading S axis,
    (S, 1, ...), on ``device``; each item is lifted by ``frame_from_item``,
    as on the sequential path.  ``ParallelStreams.step`` takes the
    per-stream Frames instead."""
    fs = [frame_from_item(it, device, keypoint_source) for it in items]
    return Frame(*[None if getattr(fs[0], k) is None
                   else torch.stack([getattr(f, k) for f in fs])
                   for k in Frame._fields])


def stack_outs(outs: list[dict]) -> dict:
    """A list of per-stream output dicts -> one dict of host arrays with a
    leading S axis (nested dicts stacked key by key)."""
    def stack(vals):
        if isinstance(vals[0], dict):
            return {k: stack([v[k] for v in vals]) for k in vals[0]}
        return np.stack([v.detach().cpu().numpy()
                         if isinstance(v, torch.Tensor) else np.asarray(v)
                         for v in vals])

    return stack(outs)


class StreamView:
    """Lazy view of selected indices of a stream: items load on demand
    through the stream's ``__getitem__``, so a view over a 35k-frame 3DPW
    stream holds its index list and no preprocessed crop."""

    def __init__(self, stream, indices: list[int]):
        self.stream = stream
        self.indices = indices

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i: int) -> dict:
        return self.stream[self.indices[i]]

    def __iter__(self):
        return (self.stream[i] for i in self.indices)


def partition_items(stream, n_groups: int) -> list[StreamView]:
    """Split a stream into ``n_groups`` independent adaptation streams,
    lazily.  Streams with ``seq_lengths`` (3DPW) are dealt whole (seq,
    person) tracks round-robin, frames of a track staying in order (a track
    is one temporal stream; splitting it would break the motion history);
    others are split into contiguous chunks."""
    if not hasattr(stream, "__getitem__"):
        stream = list(stream)
    n = len(stream)
    lengths = getattr(stream, "seq_lengths", None)
    if lengths:
        groups: list[list[int]] = [[] for _ in range(n_groups)]
        start = 0
        for t, ln in enumerate(lengths):
            groups[t % n_groups].extend(range(start, start + ln))
            start += ln
        idx_groups = [g for g in groups if g]
    else:
        per = (n + n_groups - 1) // n_groups
        idx_groups = [list(range(i, min(i + per, n)))
                      for i in range(0, n, per)]
    return [StreamView(stream, g) for g in idx_groups]


def _rss_mb() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return float("nan")


class _Lane:
    """One stream inside ``run_parallel``: its items, engine and state, the
    items loading ahead on the pool, and its metrics, fetched to the host
    once per ``FLUSH`` frames as one stacked (3, W, B) array."""

    def __init__(self, items, engine: BilevelEngine, state, pool,
                 keypoint_source: str):
        self.items, self.engine, self.state = items, engine, state
        self.pool, self.keypoint_source = pool, keypoint_source
        self.device = engine.device
        self.ready: collections.deque = collections.deque()
        self.pos = 0
        self.pending: list[torch.Tensor] = []
        self.windows: list[np.ndarray] = []

    def step(self) -> bool:
        """Adapt on the next frame; False when the stream is exhausted."""
        while (len(self.ready) < PREFETCH
               and self.pos + len(self.ready) < len(self.items)):
            self.ready.append(self.pool.submit(self.items.__getitem__,
                                               self.pos + len(self.ready)))
        if not self.ready:
            return False
        item = self.ready.popleft().result()
        self.pos += 1
        frame = frame_from_item(item, self.device, self.keypoint_source)
        self.state, out = self.engine.step(self.state, frame)
        self.pending.append(torch.stack([out[k] for k in METRIC_KEYS]))
        if len(self.pending) >= FLUSH:
            self.flush()
            # items are allocated on pool threads and freed here: without
            # trims glibc's per-thread arenas keep the freed pages
            malloc_trim()
        return True

    def sync(self) -> None:
        """Wait for this stream's queued work."""
        if self.pending:
            self.pending[-1].cpu()

    def flush(self) -> None:
        if self.pending:
            self.windows.append(torch.stack(self.pending, 1).cpu().numpy())
            self.pending.clear()

    def summary(self) -> dict:
        win = (np.concatenate(self.windows, axis=1) if self.windows
               else np.zeros((3, 0, 1)))
        return ({k: (float(win[j].mean()) if win.shape[1] else float("nan"))
                 for j, k in enumerate(METRIC_KEYS)}
                | {"frames": win.shape[1]})


def run_parallel(engine: BilevelEngine, params: dict, groups: list,
                 devices=None, keypoint_source: str = "gt", log=print,
                 progress_every: int = 0) -> dict:
    """Adapt S independent streams over ``devices`` (all CUDA devices by
    default): the product entry of ``--parallel_streams``.

    ``groups`` holds one item sequence per stream, e.g. the lazy views of
    :func:`partition_items`; items load on access, on a thread pool,
    ``PREFETCH`` ahead per stream.  Every stream starts from ``params`` with
    private weights, optimizer and history; streams of unequal length stop
    when exhausted.  The first frame of every stream (a warmup round:
    kernel builds, cuDNN autotuning, allocator growth) is excluded from the
    timed region; the streams are stepped round robin.
    ``progress_every > 0`` logs aggregate frames/s and the host RSS every N
    frames.  An exception in any stream fails the run.

    Returns {"mpjpe", "pampjpe", "pve", "frames", "fps", "per_stream"}: the
    metrics are frame-weighted means over the streams; an empty stream
    reports NaN and is left out of them."""
    par = ParallelStreams(engine, devices or make_mesh())
    S = len(groups)
    probe_s = next((s for s, g in enumerate(groups) if len(g)), None)
    if probe_s is None:
        raise ValueError("run_parallel: every stream is empty")
    first = groups[probe_s][0]
    img_res = (first["image"].shape[0] if "image" in first
               else int(first.get("out_res", 224)))
    states = par.init_states(params, S, img_res=img_res)
    pool = ThreadPoolExecutor(max_workers=min(8, max(2, S)))
    lanes = [_Lane(groups[s], par.engine_for(par.device_of(s)), states[s],
                   pool, keypoint_source) for s in range(S)]
    # the probe already loaded that stream's first item
    loaded = Future()
    loaded.set_result(first)
    lanes[probe_s].ready.append(loaded)

    t0, timed0, dispatched = time.perf_counter(), 0, 0
    try:
        alive = True
        while alive:
            alive = False
            for lane in lanes:
                if not lane.step():
                    continue
                alive = True
                dispatched += 1
                if progress_every and dispatched % progress_every == 0:
                    rate = (dispatched - timed0) / (time.perf_counter() - t0)
                    log(f"[parallel x{S}] dispatched {dispatched} frames "
                        f"({rate:.1f}/s, RSS {_rss_mb():.0f} MB)")
            if not timed0:
                # the warmup round ends: wait for it, then start the timer
                for lane in lanes:
                    lane.sync()
                t0, timed0 = time.perf_counter(), dispatched
        for lane in lanes:
            lane.flush()
    finally:
        pool.shutdown(wait=True)
    malloc_trim()
    elapsed = time.perf_counter() - t0
    per_stream = [lane.summary() for lane in lanes]
    total = sum(p["frames"] for p in per_stream)
    fps = max(total - timed0, 1) / elapsed
    # a zero-frame stream's NaN must not poison the frame-weighted mean
    agg = {k: sum(p[k] * p["frames"] for p in per_stream if p["frames"])
           / total for k in METRIC_KEYS}
    log(f"[parallel x{S}] {total} frames over {len(par.devices)} device(s): "
        f"MPJPE:{agg['mpjpe']:.2f} PA:{agg['pampjpe']:.2f} "
        f"PVE:{agg['pve']:.2f} ({fps:.2f} aggregate fps)")
    return agg | {"frames": total, "fps": fps, "per_stream": per_stream}

