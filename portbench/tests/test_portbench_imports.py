"""What the benchmark may import: nothing of JAX or the JAX package
anywhere, and in the reference nothing of the program either."""

import ast
import os

import pytest

from portbench.lib import harness, spec

HERE = os.path.join(spec.ROOT, "portbench")


def _imports(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def _sources(sub=""):
    for dirpath, dirnames, filenames in os.walk(os.path.join(HERE, sub)):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in filenames:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


@pytest.mark.parametrize("loaded,bad", [
    (["encodec_tpu_torch", "encodec_tpu_torch.models"], []),
    (["encodec_tpu", "torch"], ["encodec_tpu"]),
    (["encodec_tpu.models.model"], ["encodec_tpu.models.model"]),
    (["jax", "jax.numpy", "jaxlib.xla_client"],
     ["jax", "jax.numpy", "jaxlib.xla_client"]),
    (["flax.linen"], ["flax.linen"]),
    (["jaxtyping", "encodec_tpu_torchx", "encodec_tpu2"], []),
])
def test_forbidden_modules_compare_top_level_names_whole(loaded, bad):
    assert harness.forbidden_modules(loaded) == sorted(bad)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"torch", "math", "typing", "__future__", "numpy"}, \
            (path, tops)
