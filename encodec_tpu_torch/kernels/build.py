"""Build and bind the hand-written CUDA kernels (`csrc/*.cu`).

Each source compiles with `nvcc` for `sm_90a` into its own shared library
with a plain C interface, loaded with `ctypes` — no PyTorch headers, so a
build takes seconds. Libraries land in `_build/<hash>/` next to this file
(listed in `.gitignore`), keyed by a hash of the source, the shared
headers (`csrc/*.cuh`) and the flags, so an edited source or header
rebuilds and an unchanged one is reused within a checkout.

Nothing is built at import time: `load_library` builds on first use, and
`build_all` starts one `nvcc` per source in parallel (used by the smoke
script to pay the build once, up front). No `--use_fast_math`: the LSTM
gates need IEEE `expf`/`tanhf`, and the VQ distances need plain FFMA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import typing as tp
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signatures of each library's entry points: (argtypes, restype). Every
# pointer and the stream go as c_void_p, or ctypes would cut them to 32 bits.
SIGNATURES: tp.Dict[str, tp.Dict[str, tp.Tuple[list, tp.Any]]] = {
    "ac_decode": {
        "ac_head_pull_launch": ([_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I,
                                 _I, _L, _L, _P, _P, _P, _P, _I, _L, _P], _I),
        "ac_head_pull_threads": ([], _I),
        "ac_head_pull_cluster": ([], _I),
        "ac_head_pull_max_card": ([], _I),
        "ac_head_pull_smem_bytes": ([_I], _L),
        "ac_decode_error_string": ([_I], ctypes.c_char_p),
    },
    "lstm_scan": {
        "lstm_scan_launch": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _P], _I),
        "lstm_scan_max_clusters": ([_I, _I], _I),
        "lstm_scan_attributes": ([_I, _I, _I, _P, _P], _I),
        "lstm_scan_smem_bytes": ([_I, _I], _I),
        "lstm_scan_units_per_cta_max": ([], _I),
        "lstm_scan_max_cluster": ([], _I),
        "lstm_scan_reg_rows": ([_I], _I),
        "lstm_scan_threads": ([], _I),
        "lstm_scan_max_seqs": ([], _I),
        "lstm_scan_error_string": ([_I], ctypes.c_char_p),
    },
    "lstm_bwd_cluster": {
        "lstm_bwd_cluster_launch": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                     _I, _I, _I, _I, _I, _I, _P], _I),
        "lstm_bwd_cluster_max_clusters": ([_I, _I], _I),
        "lstm_bwd_cluster_attributes": ([_I, _I, _P, _P], _I),
        "lstm_bwd_cluster_smem_bytes": ([_I, _I], _I),
        "lstm_bwd_cluster_units_per_cta_max": ([], _I),
        "lstm_bwd_cluster_max_cluster": ([], _I),
        "lstm_bwd_cluster_reg_rows": ([_I], _I),
        "lstm_bwd_cluster_threads": ([], _I),
        "lstm_bwd_cluster_max_seqs": ([], _I),
        "lstm_bwd_cluster_error_string": ([_I], ctypes.c_char_p),
    },
    "lstm_grid": {
        "lstm_grid_launch": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _P], _I),
        "lstm_grid_max_ctas": ([_I, _I], _I),
        "lstm_grid_attributes": ([_I, _I, _P, _P], _I),
        "lstm_grid_smem_bytes": ([_I, _I], _I),
        "lstm_grid_threads": ([], _I),
        "lstm_grid_max_units": ([], _I),
        "lstm_grid_lane_rows": ([], _I),
        "lstm_grid_lane_k": ([], _I),
        "lstm_grid_batch_tile": ([], _I),
        "lstm_grid_max_batch": ([], _I),
        "lstm_grid_max_h": ([], _I),
        "lstm_grid_fenced": ([_I], _I),
        "lstm_grid_error_string": ([_I], ctypes.c_char_p),
    },
    "lstm_bwd": {
        "lstm_bwd_launch": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                             _I, _I, _I, _I, _P], _I),
        "lstm_bwd_max_ctas": ([_I, _I, _I], _I),
        "lstm_bwd_attributes": ([_I, _P, _P], _I),
        "lstm_bwd_smem_bytes": ([_I, _I, _I], _I),
        "lstm_bwd_threads": ([], _I),
        "lstm_bwd_max_units": ([], _I),
        "lstm_bwd_min_units": ([], _I),
        "lstm_bwd_cols": ([], _I),
        "lstm_bwd_batch_tile": ([], _I),
        "lstm_bwd_max_h": ([], _I),
        "lstm_bwd_max_ctas_limit": ([], _I),
        "lstm_bwd_error_string": ([_I], ctypes.c_char_p),
    },
    "vq_search": {
        "vq_nearest_launch": ([_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
                              _I),
        "vq_nearest_smem_bytes": ([_I], _I),
        "vq_nearest_rows_per_cta": ([], _I),
        "vq_nearest_tile_bins": ([], _I),
        "vq_nearest_threads": ([], _I),
        "vq_nearest_max_cluster": ([], _I),
        "vq_rowblock_launch": ([_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
                               _I),
        "vq_rowblock_attributes": ([_P, _P, _P], _I),
        "vq_rowblock_resident": ([_I], _I),
        "vq_rowblock_smem_bytes": ([], _I),
        "vq_rowblock_rows_per_cta": ([], _I),
        "vq_rowblock_tile_bins": ([], _I),
        "vq_rowblock_slab": ([], _I),
        "vq_rowblock_stages": ([], _I),
        "vq_rowblock_threads": ([], _I),
        "vq_rvq_launch": ([_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P], _I),
        "vq_rvq_smem_bytes": ([_I], _I),
        "vq_rvq_rows_per_cta": ([], _I),
        "vq_rvq_tile_bins": ([], _I),
        "vq_rvq_threads": ([], _I),
        "vq_rvq_max_cluster": ([], _I),
        "vq_search_error_string": ([_I], ctypes.c_char_p),
    },
}

_LIBS: tp.Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


class KernelBuildError(RuntimeError):
    """A kernel library could not be compiled or loaded."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found (PATH or $CUDA_HOME/bin); the "
                           "CUDA kernels are built on the machine with the "
                           "GPU at first use")


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise KernelBuildError(f"missing kernel source {src}")
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # what the sources include
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


_Pending = tp.Tuple[Path, tp.Optional[subprocess.Popen], Path]


def _start(name: str) -> _Pending:
    """Start nvcc for `csrc/<name>.cu` unless its library is already built.
    It writes a private temporary file that `_finish` renames into place, so
    concurrent processes never load a half-written library."""
    out = _lib_path(name)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    if out.exists():
        return out, None, tmp
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, proc, tmp


def _finish(name: str, out: Path, proc: tp.Optional[subprocess.Popen],
            tmp: Path) -> ctypes.CDLL:
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise KernelBuildError(f"nvcc failed for {name}.cu "
                                   f"(rc={proc.returncode}):\n{log}")
        os.replace(tmp, out)
    try:
        lib = ctypes.CDLL(str(out))
    except OSError as exc:
        raise KernelBuildError(f"cannot load {out}: {exc}") from exc
    for fn, (argtypes, restype) in SIGNATURES.get(name, {}).items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def kernel_names() -> tp.List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> tp.Dict[str, ctypes.CDLL]:
    """Compile every `csrc/*.cu` in parallel (one nvcc each) and load them."""
    with _LOCK:
        pending: tp.Dict[str, _Pending] = {}
        try:
            for n in kernel_names():
                if n not in _LIBS:
                    pending[n] = _start(n)
            for n, started in pending.items():
                _LIBS[n] = _finish(n, *started)
        finally:
            # one failed build must not leave the other compilers running
            for _out, proc, _tmp in pending.values():
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
        return dict(_LIBS)


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it on first use."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = _finish(name, *_start(name))
        return _LIBS[name]


def check(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise when an entry point of library `name` returns a CUDA error."""
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc)
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg.decode() if msg else '?'})")
