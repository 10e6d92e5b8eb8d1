"""Reading the JAX trainer's checkpoints (format v2), without JAX.

The read side of `encodec_tpu/train/checkpoint.py` (`FORMAT_VERSION`,
`CheckpointVersionError`, `_decode_struct`, `previous_path`,
`load_checkpoint`, `load_checkpoint_with_fallback`). A `.ckpt` is an npz
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
part into the port's parameters. Saving waits for the port's trainer.
"""

from __future__ import annotations

import collections
import json
import logging
import typing as tp
import zipfile
from pathlib import Path

import numpy as np

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
