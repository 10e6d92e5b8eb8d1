"""Finding a cell's files by name, and the metrics `BENCHMARK.json` asks
of it.

- `BENCHMARK.json` at the checkout's root: cells, metrics, bounds;
- `portbench/workloads/<cell>.json`: the configuration's name, the chips,
  the traffic (its `kind` picks the driver in `lib/`), the traced window
  and the correctness check's limits;
- `portbench/configs/<config>.json`: the published configuration, its
  family, how the program builds it, `reduced` and `assumed`;
- `portbench/metrics/<metric>.py`: one reader per per-layer metric, a
  function `read(m)` returning a number or None.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import os
import typing as tp

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def workload(name: str) -> dict:
    return load_json(os.path.join(HERE, "workloads", f"{name}.json"))


def config(name: str) -> dict:
    return load_json(os.path.join(HERE, "configs", f"{name}.json"))


def merge(base: dict, over: tp.Optional[dict]) -> dict:
    """`base` with `over`'s keys put in, dicts merged key by key."""
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def metrics_for(bench: dict, cell: str, kind: str) -> tp.List[dict]:
    """The `end_to_end` or `per_layer` metrics a cell reports: those that
    list it under `workloads`, and those without that key."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def reader(name: str) -> tp.Callable:
    """The `read` function of `metrics/<name>.py`."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    mod_name = "portbench_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
