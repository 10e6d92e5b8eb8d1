"""Isolation and honesty checks of the PyTorch/CUDA port.

- No module of `encodec_tpu_torch/` and not `chip_smoke.py` imports `jax`
  or `encodec_tpu` (the port keeps its own copies of what it needs).
- The port passes the repo's enforcing lint.
- Asking for the GPU without one raises instead of running on the CPU.
- A kernel wrapper handed a CUDA tensor launches its kernel or raises; it
  never falls back to its plain twin (simulated here, on a machine without
  a GPU, with a CUDA-placed stand-in tensor and a failing library loader).
- `chip_smoke.py` fails without a GPU, and alone in a directory.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "encodec_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "encodec_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax_and_no_jax_package():
    files = _port_files()
    assert len(files) > 15
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            if top in FORBIDDEN:
                bad.append(f"{f.relative_to(REPO)}: {mod}")
    assert not bad, bad


def test_port_is_lint_clean():
    targets = ["encodec_tpu_torch", "chip_smoke.py"] + sorted(
        str(p.relative_to(REPO)) for p in (REPO / "tests").glob("test_torch_*.py"))
    proc = subprocess.run([sys.executable, str(REPO / "tools" / "lint.py"),
                           *targets], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:]


def test_cuda_request_without_gpu_raises(monkeypatch):
    from encodec_tpu_torch import resolve_device
    from encodec_tpu_torch.models import build_model, encodec_model_24khz

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encodec_model_24khz()                      # default device is cuda
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model([6.0], sample_rate=24000, n_filters=2, dimension=8,
                    bins=16, device="cuda:0")
    assert resolve_device("cpu").type == "cpu"
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


class _CudaStandIn:
    """Quacks like a contiguous float32 CUDA tensor for argument checks."""

    def __init__(self, *shape, dtype=torch.float32):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = torch.device("cuda", 0)

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True


@pytest.mark.parametrize("which", ["nearest_codebook", "rvq_encode_fused",
                                   "lstm_scan", "lstm_scan_grid",
                                   "lstm_scan_backward", "ac_head_pull"])
def test_wrappers_raise_instead_of_falling_back(monkeypatch, which):
    from encodec_tpu_torch import kernels
    from encodec_tpu_torch.kernels import ac_cuda, build, lstm_cuda, vq_cuda

    def no_build(name):
        raise build.KernelBuildError(f"simulated build failure of {name}")

    def no_twin(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain twin")

    monkeypatch.setattr(build, "load_library", no_build)
    for mod in (lstm_cuda, vq_cuda, ac_cuda):
        for name in ("lstm_scan_plain", "nearest_codebook_plain",
                     "rvq_encode_fused_plain", "lstm_scan_backward_plain",
                     "ac_head_pull_plain"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, no_twin)
    args = {
        "nearest_codebook": (_CudaStandIn(10, 8), _CudaStandIn(16, 8)),
        "rvq_encode_fused": (_CudaStandIn(10, 8), _CudaStandIn(2, 16, 8), 2),
        "lstm_scan": (_CudaStandIn(2, 5, 16), _CudaStandIn(16, 4)),
        # H=1024: K3's grid kernel
        "lstm_scan_grid": (_CudaStandIn(2, 5, 4096), _CudaStandIn(4096, 1024)),
        # K3's backward kernel: pre-activations, c, dy, W_hh
        "lstm_scan_backward": (_CudaStandIn(2, 5, 16), _CudaStandIn(2, 5, 4),
                               _CudaStandIn(2, 5, 4), _CudaStandIn(16, 4)),
        # the range decoder: state, acc, head_b, e0, lut, data, nbits, ts,
        # t, codes, feed, ok, eof
        "ac_head_pull": (
            _CudaStandIn(2, 5, dtype=torch.int64),
            _CudaStandIn(4, 2, 16, dtype=torch.float64),
            _CudaStandIn(4, 16, dtype=torch.int32), 3,
            _CudaStandIn(1024, dtype=torch.int64),
            _CudaStandIn(2, 9, dtype=torch.uint8),
            _CudaStandIn(2, dtype=torch.int64),
            _CudaStandIn(2, dtype=torch.int64),
            _CudaStandIn(1, dtype=torch.int64),
            _CudaStandIn(3, 2, 4, dtype=torch.int64),
            _CudaStandIn(2, 4, dtype=torch.int64),
            _CudaStandIn(2, dtype=torch.bool),
            _CudaStandIn(2, dtype=torch.bool)),
    }[which]
    fn = getattr(kernels, which.replace("_grid", ""))
    before = fn.launches
    with pytest.raises(build.KernelBuildError, match="simulated"):
        fn(*args)
    assert fn.launches == before
    # a mixed-device call is refused before any launch
    with pytest.raises(ValueError, match="different devices"):
        fn(torch.zeros(args[0].shape, dtype=args[0].dtype), *args[1:])


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from encodec_tpu_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(build, "_LIBS", {})
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.load_library("vq_search")


def test_build_all_reports_compiler_failure(monkeypatch, tmp_path):
    """A failing nvcc raises with its output; nothing is left half-built."""
    from encodec_tpu_torch.kernels import build
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'fake nvcc: error in source'\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(build.shutil, "which", lambda name: str(fake))
    monkeypatch.setattr(build, "_LIBS", {})
    with pytest.raises(build.KernelBuildError, match="fake nvcc: error"):
        build.build_all()
    assert not list((tmp_path / "build").rglob("*.so"))


def test_wrapper_launch_counters_exist():
    from encodec_tpu_torch import kernels
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == {"nearest_codebook": 0,
                                       "rvq_encode_fused": 0, "lstm_scan": 0,
                                       "lstm_scan_backward": 0,
                                       "ac_head_pull": 0}
    # CPU tensors run the plain twins and count no launch
    kernels.nearest_codebook(torch.randn(4, 8), torch.randn(5, 8))
    assert kernels.launch_counts()["nearest_codebook"] == 0


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu_or_repo(tmp_path, alone):
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    else:
        cwd = REPO
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
