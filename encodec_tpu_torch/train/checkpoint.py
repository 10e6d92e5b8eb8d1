"""Training checkpoints (format v2), without JAX.

Port of `encodec_tpu/train/checkpoint.py`: the read side
(`FORMAT_VERSION`, `CheckpointVersionError`, `_decode_struct`,
`previous_path`, `load_checkpoint`, `load_checkpoint_with_fallback`) and
the save side (`_to_numpy`, `_encode_struct`, `save_checkpoint`). A `.ckpt`
is an npz
(zip) of the tree's leaves as plain arrays plus a JSON manifest of the tree
structure (dicts, lists, tuples, namedtuples by name and fields), the epoch
and extra metadata. Loading uses `np.load(allow_pickle=False)` and `json`
only, so no path executes bytes from the file; v1 (pickled) files and
future format versions are refused.

Namedtuple nodes are resolved against a fixed allowlist of the port's own
state classes (`encodec_tpu_torch.quant.rvq`: `RVQState`) by saved name and
fields, else synthesized with `collections.namedtuple`: field access and
unpacking behave alike, only class identity differs (a `TrainState` comes
back synthesized, with `params` and `qstate` as its first two fields).
Leaves stay numpy arrays; `models.zoo.params_from_jax` turns the model's
part into the port's parameters (`train_state_from_jax` the whole
`TrainState`).

Saving writes the same manifest structure the JAX package writes, so
`encodec_tpu.train.checkpoint.load_checkpoint` (without a target) opens a
file the port wrote; tensors are written as numpy arrays, on any device.
The write is atomic (a temporary file, fsync'd, renamed over the target),
the previous generation is rotated to `<path>.prev` first, and the payload
carries `format_version`.

`AsyncCheckpointer` (JAX's, :289-336) overlaps a save with training: a
snapshot of the state on the device (new tensors, so the next step cannot
race the writer), the device-to-host copy on a side stream fenced by an
event, and `save_checkpoint` on one writer thread, at most one write in
flight; a writer's error is raised by the next `save` or `wait`.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
import typing as tp
import zipfile
from pathlib import Path

import numpy as np
import torch

FORMAT_VERSION = 2

log = logging.getLogger(__name__)


class CheckpointVersionError(ValueError):
    """The file's format cannot be loaded by this build: a format version
    from the future, or a v1 (pickled) file. Not swallowed by
    `load_checkpoint_with_fallback`: falling back to an older generation
    would hide that the newest one cannot be read."""


# A fixed allowlist (never taken from the file): the manifest can pick
# among these classes but never cause an import of anything else.
_NT_MODULES = ("encodec_tpu_torch.quant.rvq",)   # RVQState


def _canonical_namedtuples() -> dict:
    """(name, fields) -> class, scanned once from `_NT_MODULES`."""
    reg = getattr(_canonical_namedtuples, "_reg", None)
    if reg is None:
        import importlib
        reg = {}
        for modname in _NT_MODULES:
            mod = importlib.import_module(modname)
            for obj in vars(mod).values():
                if (isinstance(obj, type) and issubclass(obj, tuple)
                        and hasattr(obj, "_fields")):
                    reg.setdefault((obj.__name__, tuple(obj._fields)), obj)
        _canonical_namedtuples._reg = reg  # type: ignore[attr-defined]
    return reg


def _to_numpy(tree):
    """Tensors (any device) → numpy, through dicts, lists and tuples
    (namedtuples keep their class); other leaves as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_numpy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def _encode_struct(x, leaves: list):
    """Describe a tree as JSON-able data, appending its leaves (as numpy)
    to `leaves`: dict, list, tuple, namedtuple and None containers; anything
    else is a leaf array or scalar."""
    if x is None:
        return {"t": "none"}
    if isinstance(x, dict):
        enc_keys = []
        for k in x:
            if isinstance(k, str):
                enc_keys.append(["s", k])
            elif isinstance(k, (int, np.integer)):
                enc_keys.append(["i", int(k)])
            else:
                raise TypeError(f"unsupported dict key in checkpoint: {k!r}")
        return {"t": "dict", "k": enc_keys,
                "c": [_encode_struct(v, leaves) for v in x.values()]}
    if isinstance(x, tuple) and hasattr(x, "_fields"):   # namedtuple
        return {"t": "nt", "n": type(x).__name__, "f": list(x._fields),
                "c": [_encode_struct(v, leaves) for v in x]}
    if isinstance(x, tuple):
        return {"t": "tuple", "c": [_encode_struct(v, leaves) for v in x]}
    if isinstance(x, list):
        return {"t": "list", "c": [_encode_struct(v, leaves) for v in x]}
    # a leaf: keep the python-scalar kind so loading restores exact types
    kind = "a"
    if isinstance(x, bool):
        kind = "b"
    elif isinstance(x, int):
        kind = "i"
    elif isinstance(x, float):
        kind = "f"
    idx = len(leaves)
    leaves.append(np.asarray(x))
    return {"t": "leaf", "i": idx, "k": kind}


def _decode_struct(node: dict, leaves: tp.Sequence[np.ndarray],
                   nt_cache: tp.Dict[tuple, type]) -> tp.Any:
    t = node["t"]
    if t == "none":
        return None
    if t == "dict":
        keys = [k if tag == "s" else int(k) for tag, k in node["k"]]
        return {k: _decode_struct(c, leaves, nt_cache)
                for k, c in zip(keys, node["c"])}
    if t == "nt":
        sig = (node["n"], tuple(node["f"]))
        if sig not in nt_cache:
            nt_cache[sig] = _canonical_namedtuples().get(
                sig) or collections.namedtuple(  # type: ignore[misc]
                    node["n"], list(node["f"]))
        vals = [_decode_struct(c, leaves, nt_cache) for c in node["c"]]
        return nt_cache[sig](*vals)
    if t == "tuple":
        return tuple(_decode_struct(c, leaves, nt_cache) for c in node["c"])
    if t == "list":
        return [_decode_struct(c, leaves, nt_cache) for c in node["c"]]
    arr = leaves[node["i"]]
    kind = node.get("k", "a")
    if kind == "b":
        return bool(arr)
    if kind == "i":
        return int(arr)
    if kind == "f":
        return float(arr)
    return arr


def previous_path(path: tp.Union[str, Path]) -> Path:
    """The rotated previous-generation checkpoint next to `path`."""
    path = Path(path)
    return path.with_suffix(path.suffix + ".prev")


def save_checkpoint(state, epoch: int, path: tp.Union[str, Path],
                    extra: tp.Optional[dict] = None,
                    keep_previous: bool = True) -> None:
    """Write `state` (a tree of tensors, arrays and scalars) and `epoch` to
    `path` atomically, rotating an existing file to `<path>.prev` first.
    `extra` must be JSON-serializable."""
    leaves: tp.List[np.ndarray] = []
    tree = _encode_struct(_to_numpy(state), leaves)
    manifest = json.dumps({
        "format_version": FORMAT_VERSION,
        "epoch": int(epoch),
        "extra": extra or {},
        "tree": tree,
        "nleaves": len(leaves),
    }).encode("utf-8")
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as fh:
        np.savez(fh, __manifest__=np.frombuffer(manifest, np.uint8),
                 **{f"L{i}": a for i, a in enumerate(leaves)})
        fh.flush()
        os.fsync(fh.fileno())
    if keep_previous and path.exists():
        # rotate before the final rename: whatever happens from here on, a
        # complete generation survives at either `path` or `path.prev`
        os.replace(path, previous_path(path))
    os.replace(tmp, path)
    try:  # persist the renames themselves (POSIX: directory fsync)
        dirfd = os.open(path.parent or Path("."), os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)
    except OSError:
        pass  # non-POSIX or restricted fs: the renames are still atomic


def _snapshot(tree, copies: list):
    """A copy of every tensor leaf of `tree` (namedtuples keep their class),
    on its own device; CUDA leaves are appended to `copies`."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().clone()
        if t.is_cuda:
            copies.append(t)
        return t
    if isinstance(tree, dict):
        return {k: _snapshot(v, copies) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_snapshot(v, copies) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_snapshot(v, copies) for v in tree)
    return tree


def _to_host(tree, stream, buffers: tp.Iterator[torch.Tensor]) -> tp.Any:
    """CUDA leaves → the next pinned host buffers of `buffers`, copied on
    `stream` (not waited for); other leaves as they are."""
    if isinstance(tree, torch.Tensor):
        if not tree.is_cuda:
            return tree
        host = next(buffers)
        tree.record_stream(stream)
        host.copy_(tree, non_blocking=True)
        return host
    if isinstance(tree, dict):
        return {k: _to_host(v, stream, buffers) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_host(v, stream, buffers) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v, stream, buffers) for v in tree)
    return tree


class AsyncCheckpointer:
    """Overlap checkpoint writes with training (JAX's `AsyncCheckpointer`).

    `save()` waits for the write in flight (ordering kept, and a slow disk
    cannot queue snapshots), then copies the state on its device (the
    current stream: the copy sees every update queued before it, and the
    steps after it cannot touch it), copies that snapshot to pinned host
    memory on a side stream, records an event there, and starts one writer
    thread that waits on the event and runs `save_checkpoint`. It returns
    once the copies are queued: the caller blocks for the snapshot's
    launch, not for the transfer or the disk. The pinned buffers are kept
    for the next save of a state of the same layout (the write before it
    is done by then), so only the first save pays their allocation.
    `wait()` blocks until the write is done and re-raises its error; a
    failed write is also raised by the next `save()`."""

    def __init__(self):
        self._thread: tp.Optional[threading.Thread] = None
        self._error: tp.Optional[BaseException] = None
        self._streams: tp.Dict[torch.device, tp.Any] = {}
        self._pinned: tp.List[torch.Tensor] = []

    def save(self, state, epoch: int, path: tp.Union[str, Path],
             extra: tp.Optional[dict] = None,
             keep_previous: bool = True) -> None:
        self.wait()
        cuda: tp.List[torch.Tensor] = []
        snap = _snapshot(state, cuda)
        event = None
        if cuda:
            dev = cuda[0].device
            stream = self._streams.get(dev)
            if stream is None:
                stream = self._streams[dev] = torch.cuda.Stream(dev)
            layout = [(t.shape, t.dtype) for t in cuda]
            if [(t.shape, t.dtype) for t in self._pinned] != layout:
                self._pinned = [torch.empty(shape, dtype=dtype,
                                            pin_memory=True)
                                for shape, dtype in layout]
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                snap = _to_host(snap, stream, iter(self._pinned))
                event = torch.cuda.Event()
                event.record(stream)

        def run():
            try:
                if event is not None:
                    event.synchronize()
                save_checkpoint(snap, epoch, path, extra=extra,
                                keep_previous=keep_previous)
            except BaseException as e:  # raised by the next save()/wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="ckpt-writer")
        self._thread.start()

    def wait(self) -> None:
        """Block until the write in flight (if any) is done; re-raise its
        error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def load_checkpoint(path: tp.Union[str, Path]):
    """Returns (state tree, epoch, extra); resume at epoch+1.

    Raises on a truncated or corrupt file, a future format version or a
    v1 (pickled) file; `load_checkpoint_with_fallback` degrades to the
    previous generation for the first."""
    with open(path, "rb") as fh:
        head = fh.read(4)
    # a pickle starts with its protocol opcode (protocol 2+) or a mark
    if head[:1] in (b"\x80", b"("):
        raise CheckpointVersionError(
            f"checkpoint {path} is a v1 (pickled) file; it is not "
            "deserialized, since loading one could execute arbitrary code. "
            "Re-save it with a trusted build of the JAX trainer that still "
            "reads v1, which writes the pickle-free v2 format.")
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(bytes(z["__manifest__"]).decode("utf-8"))
        version = manifest.get("format_version", 0)
        if version > FORMAT_VERSION:
            raise CheckpointVersionError(
                f"checkpoint {path} has format_version={version}, newer "
                f"than this build's {FORMAT_VERSION}; refusing to load")
        leaves = [z[f"L{i}"] for i in range(manifest["nleaves"])]
    state = _decode_struct(manifest["tree"], leaves, {})
    return state, manifest["epoch"], manifest.get("extra", {})


def load_checkpoint_with_fallback(path: tp.Union[str, Path]):
    """`load_checkpoint`, falling back to the rotated `.prev` generation
    when the newest file is missing, truncated or corrupt. A
    `CheckpointVersionError` is re-raised. Returns (state, epoch, extra);
    raises only when no loadable generation exists."""
    path = Path(path)
    try:
        return load_checkpoint(path)
    except CheckpointVersionError:
        raise
    except (EOFError, zipfile.BadZipFile, ValueError, OSError,
            KeyError, AttributeError, json.JSONDecodeError) as e:
        prev = previous_path(path)
        if not prev.exists():
            raise
        log.warning(
            "checkpoint %s is unreadable (%s: %s); falling back to "
            "previous generation %s", path, type(e).__name__, e, prev)
        return load_checkpoint(prev)
