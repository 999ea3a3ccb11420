"""Checkpoint / resume of the port's ``AdaptState`` in the JAX package's v2
format (counterpart of ``dynaboa_tpu/engine/checkpoint.py``), so that a
checkpoint written by either package loads into the other.

The v2 file is a zip (npz) with a ``meta.json`` manifest of leaves and one
flat ``packed_<dtype>.npy`` entry per dtype, written to ``<path>.tmp`` and
renamed into place.  The leaves follow the order in which
``jax.tree.flatten`` visits the JAX ``AdaptState``:

  params (the flax HMR tree, dict keys sorted), teacher params (same order),
  the optax Adam state ``count``, ``mu``, ``nu``, then ``hist_images``,
  ``hist_j2d``, ``step`` (int32) and the uint32 (2,) rng key.

The port's state maps onto them as follows:
- each torch parameter sits at its flax path, in the flax layout (conv
  kernels HWIO, dense kernels (in, out), GroupNorm ``weight`` as ``scale``):
  the inverse of ``models.hmr.params_from_jax``;
- torch ``Adam``'s ``step`` / ``exp_avg`` / ``exp_avg_sq`` are ``count`` /
  ``mu`` / ``nu``;
- the rng leaf holds ``[0, seed]`` (``jax.random.PRNGKey(seed)``), and the
  ``torch.Generator`` state rides in an extra ``torch_generator.npy`` entry,
  which the JAX loader skips (it reads only ``meta.json`` and
  ``packed_*``).  A checkpoint without that entry (one written by the JAX
  package) reseeds the generator from the template's seed: the random
  streams of the two packages differ anyway (docs/PARITY.md divergence 2).

Not ported: the legacy v1 per-leaf format, the sliced device fetch and the
duty-cycle cooldown of the JAX writer, which were tuned for a slow
transport.
"""

from __future__ import annotations

import ctypes
import io
import json
import os
import queue
import threading
import zipfile

import numpy as np
import torch

from dynaboa_tpu_torch.engine.bilevel import AdaptState

FORMAT_VERSION = 2
_GENERATOR_ENTRY = "torch_generator.npy"
_DENSE = ("fc1", "fc2", "decpose", "decshape", "deccam")


def malloc_trim():
    """Return freed heap pages to the OS (no-op off glibc)."""
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except OSError:
        pass


# -- torch parameter name <-> flax path and layout ----------------------------

def flax_path(name: str) -> tuple[tuple[str, ...], str]:
    """Flax key path of an HMR parameter and its layout kind (``conv``,
    ``dense`` or ``vec``)."""
    *mod, leaf = name.split(".")
    kernel = leaf == "weight"
    if mod[0] in _DENSE:
        return (mod[0], "kernel" if kernel else "bias"), \
            "dense" if kernel else "vec"
    gn_leaf = "scale" if kernel else "bias"
    if mod == ["conv1"]:
        return ("conv1", "kernel"), "conv"
    if mod == ["bn1"]:
        return ("gn1", gn_leaf), "vec"
    block, sub = f"{mod[0]}_{mod[1]}", mod[2:]
    if sub[0].startswith("conv"):
        return (block, sub[0], "kernel"), "conv"
    if sub[0].startswith("bn"):
        return (block, f"gn{sub[0][2:]}", gn_leaf), "vec"
    if sub == ["downsample", "0"]:
        return (block, "down_conv", "kernel"), "conv"
    if sub == ["downsample", "1"]:
        return (block, "down_gn", gn_leaf), "vec"
    raise KeyError(f"no flax path for parameter {name!r}")


def _to_flax(t: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "conv":
        return t.permute(2, 3, 1, 0)          # OIHW -> HWIO
    if kind == "dense":
        return t.t()                          # (out, in) -> (in, out)
    return t


def _from_flax(a: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":
        return np.transpose(a, (3, 2, 0, 1))  # HWIO -> OIHW
    if kind == "dense":
        return a.T
    return a


def _flax_order(params: dict) -> list[tuple[str, str]]:
    """(name, kind) of every parameter in jax.tree.flatten's order."""
    paths = {k: flax_path(k) for k in params}
    return [(k, paths[k][1]) for k in sorted(params, key=lambda k: paths[k][0])]


# -- pack -----------------------------------------------------------------------

def _adam_count(optimizer, params: dict) -> int:
    steps = {int(optimizer.state[p]["step"]) for p in params.values()
             if "step" in optimizer.state.get(p, {})}
    if len(steps) > 1:
        raise ValueError(f"Adam step counts differ across parameters: {steps}")
    return steps.pop() if steps else 0


def _state_leaves(state: AdaptState) -> list:
    """Every leaf of the JAX layout, in its order: float32 leaves as torch
    tensors (on the state's device), the integer leaves as numpy."""
    order = _flax_order(state.params)
    opt = state.optimizer
    adam = [opt.state.get(state.params[k], {}) for k, _ in order]

    def moment(key):
        return [_to_flax(s[key] if key in s else
                         torch.zeros_like(state.params[k]), kind)
                for (k, kind), s in zip(order, adam)]

    seed = state.rng.initial_seed()
    return ([_to_flax(state.params[k].detach(), kind) for k, kind in order]
            + [_to_flax(state.teacher_params[k], kind) for k, kind in order]
            + [np.asarray(_adam_count(opt, state.params), np.int32)]
            + moment("exp_avg") + moment("exp_avg_sq")
            + [state.hist_images, state.hist_j2d,
               np.asarray(state.step, np.int32),
               np.asarray([seed >> 32, seed & 0xFFFFFFFF], np.uint32)])


def _dtype_name(leaf) -> str:
    return str(leaf.dtype).removeprefix("torch.")


def _pack_state(state: AdaptState):
    """Snapshot the state into one flat buffer per dtype.  The float32
    buffer is a new tensor on the state's device, so adaptation may go on
    while a worker copies it to the host."""
    with torch.no_grad():
        leaves = _state_leaves(state)
        groups: dict[str, list] = {}
        for leaf in leaves:
            groups.setdefault(_dtype_name(leaf), []).append(leaf.reshape(-1))
        packed = {k: torch.cat(v) if isinstance(v[0], torch.Tensor)
                  else np.concatenate(v) for k, v in groups.items()}
    manifest = {"version": FORMAT_VERSION, "leaves": [
        {"kind": "array", "dtype": _dtype_name(a), "shape": list(a.shape)}
        for a in leaves]}
    generator = state.rng.get_state().numpy()
    return manifest, packed, generator


def _npy_bytes(a: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.lib.format.write_array(buf, a, allow_pickle=False)
    return buf.getvalue()


def _write_packed(path: str, manifest: dict, packed: dict,
                  generator: np.ndarray) -> None:
    """Write the npz to ``path + '.tmp'`` and rename it into place, so a
    crash never leaves a torn file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr("meta.json", json.dumps(manifest).encode())
        for k, buf in packed.items():
            host = buf.cpu().numpy() if isinstance(buf, torch.Tensor) else buf
            with zf.open(f"packed_{k}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, host, allow_pickle=False)
            del host
        zf.writestr(_GENERATOR_ENTRY, _npy_bytes(generator))
    os.replace(tmp, path)
    malloc_trim()


def save_state(path: str, state: AdaptState) -> None:
    """Serialize the full adaptation state (blocking)."""
    _write_packed(path, *_pack_state(state))


# -- load -----------------------------------------------------------------------

def _read(path: str):
    """(manifest records, leaves as numpy arrays in manifest order, the
    torch generator state or None) of a v2 checkpoint."""
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        if "meta.json" not in names:
            raise ValueError(f"{path}: not a v2 checkpoint (no meta.json)")
        manifest = json.loads(zf.read("meta.json").decode())
        packed = {}
        for name in names:
            if name.startswith("packed_") and name.endswith(".npy"):
                with zf.open(name) as f:
                    packed[name[len("packed_"):-len(".npy")]] = \
                        np.lib.format.read_array(f)
        generator = None
        if _GENERATOR_ENTRY in names:
            with zf.open(_GENERATOR_ENTRY) as f:
                generator = np.lib.format.read_array(f)
    recs = manifest["leaves"]
    offs = {k: 0 for k in packed}
    leaves = []
    for rec in recs:
        k, shape = rec["dtype"], tuple(rec["shape"])
        n = int(np.prod(shape)) if shape else 1
        leaves.append(packed[k][offs[k]:offs[k] + n].reshape(shape))
        offs[k] += n
    return recs, leaves, generator


def read_groups(path: str) -> dict[str, list[np.ndarray]]:
    """The leaves of a v2 checkpoint by part of the state, in the JAX
    layout: ``params``, ``teacher``, ``count``, ``mu``, ``nu``,
    ``hist_images``, ``hist_j2d``, ``step`` and ``rng``."""
    _, leaves, _ = _read(path)
    P = (len(leaves) - 5) // 4
    return {"params": leaves[:P], "teacher": leaves[P:2 * P],
            "count": [leaves[2 * P]], "mu": leaves[2 * P + 1:3 * P + 1],
            "nu": leaves[3 * P + 1:4 * P + 1],
            "hist_images": [leaves[4 * P + 1]], "hist_j2d": [leaves[4 * P + 2]],
            "step": [leaves[4 * P + 3]], "rng": [leaves[4 * P + 4]]}


def group_diffs(path_a: str, path_b: str) -> dict[str, float]:
    """Largest absolute difference between two checkpoints by part of the
    state (``read_groups``' keys); 0.0 everywhere means bit-equal."""
    a, b = read_groups(path_a), read_groups(path_b)
    return {k: max(float(np.abs(x.astype(np.float64) - y).max())
                   for x, y in zip(a[k], b[k])) for k in a}


def load_state(path: str, template: AdaptState) -> AdaptState:
    """Restore a v2 checkpoint (written by either package) into a new state
    shaped like ``template``, on the template's device.  ``template`` is not
    modified.  Leaf shapes and dtypes must match the template's."""
    recs, leaves, generator = _read(path)
    want = _state_leaves(template)
    if len(recs) != len(want):
        raise ValueError(f"checkpoint has {len(recs)} leaves, template has "
                         f"{len(want)}: structure mismatch")
    for rec, leaf in zip(recs, want):
        if rec["kind"] != "array" or \
                tuple(rec["shape"]) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {rec} does not match the "
                             f"template's {tuple(leaf.shape)}")
        if rec["dtype"] != _dtype_name(leaf):
            raise ValueError(f"checkpoint leaf dtype {rec['dtype']} != "
                             f"template {_dtype_name(leaf)}: a cast would "
                             "break bit-exact resume")

    dev = template.hist_images.device
    order = _flax_order(template.params)
    P = len(order)

    def tree(chunk):
        return {k: torch.tensor(np.ascontiguousarray(_from_flax(a, kind)),
                                device=dev)
                for (k, kind), a in zip(order, chunk)}

    ordered = tree(leaves[:P])
    params = {k: ordered[k].requires_grad_(True) for k in template.params}
    teacher = tree(leaves[P:2 * P])
    teacher = {k: teacher[k] for k in template.teacher_params}
    count = int(leaves[2 * P])
    mu, nu = tree(leaves[2 * P + 1:3 * P + 1]), tree(leaves[3 * P + 1:4 * P + 1])
    hist_images, hist_j2d, step = leaves[4 * P + 1:4 * P + 4]

    defaults = template.optimizer.defaults
    optimizer = type(template.optimizer)(list(params.values()), **defaults)
    if count:
        step_dev = dev if defaults.get("fused") or defaults.get(
            "capturable") else torch.device("cpu")
        for k, p in params.items():
            optimizer.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32,
                                     device=step_dev),
                "exp_avg": mu[k], "exp_avg_sq": nu[k]}

    rng = torch.Generator(device=dev)
    if generator is not None:
        rng.set_state(torch.as_tensor(generator))
    else:
        rng.manual_seed(template.rng.initial_seed())
    return AdaptState(
        params=params, teacher_params=teacher, optimizer=optimizer,
        hist_images=torch.tensor(hist_images, device=dev),
        hist_j2d=torch.tensor(hist_j2d, device=dev),
        step=int(step), rng=rng,
        # the file holds no boxes: a box-conditioned state's ring restarts
        # with the template's
        hist_box=None if template.hist_box is None
        else template.hist_box.clone())


# -- asynchronous writes ----------------------------------------------------------

class AsyncCheckpointer:
    """Checkpoint without stalling the adaptation loop.

    ``submit`` snapshots the state on its device (one concatenation per
    dtype) and hands the device-to-host copy and the file write to ONE
    persistent worker thread.  At most one write is in flight: a blocking
    submit waits for the previous one, a ``block=False`` submit returns
    False while it runs, and the caller counts a skipped interval.  A failed
    write is raised once, by the next ``wait`` or blocking ``submit``."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self._done = threading.Event()
        self._done.set()
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                _write_packed(*item)
            except Exception as e:  # noqa: BLE001 -- raised by wait()
                # the worker stays alive for the next submit
                self._error = e
            finally:
                self._done.set()

    @property
    def busy(self) -> bool:
        """True while a write is in flight."""
        return not self._done.is_set()

    def submit(self, path: str, state: AdaptState, block: bool = True) -> bool:
        """Queue a checkpoint write of ``state``; with ``block=False``,
        return False instead of waiting while a write is in flight."""
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        if not block and self.busy:
            return False
        self.wait()
        snapshot = _pack_state(state)
        self._done.clear()
        self._q.put((path, *snapshot))
        return True

    def wait(self) -> None:
        self._done.wait()
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write failed: {e!r}") from e

    def close(self) -> None:
        """Join the worker after the in-flight write; a later submit starts
        a new one.  Does not raise a pending write failure: call ``wait``
        first if it matters."""
        if self._thread is None:
            return
        self._done.wait()
        self._q.put(None)
        self._thread.join()
        self._thread = None
        self._error = None
