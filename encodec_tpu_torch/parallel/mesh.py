"""Process groups and device meshes.

Port of `encodec_tpu/parallel/mesh.py` on `torch.distributed`: one process
per GPU (`torchrun --nproc_per_node=N ...`), NCCL on the card, gloo on the
CPU. `initialize_multihost` brings the default process group up from
torchrun's environment (or explicit arguments); `make_mesh`,
`make_mesh_2d` and `make_hybrid_mesh` build `DeviceMesh`es with JAX's
axis names (`"data"`, `"model"`, `"seq"`, `"pipe"`); `shard_batch` gives
a rank its rows of the global batch.

JAX's refusals are kept:
- a single process with no distributed environment is a no-op
  (`initialize_multihost` returns False);
- a caller who asked for several processes (arguments, or torchrun's
  `WORLD_SIZE > 1`) and whose handshake fails gets a loud error, never N
  diverging single-process copies;
- a mesh that needs more processes than the world holds is a clear
  `ValueError`.
A torch mesh spans the whole world, so a mesh smaller than the world is
refused too (JAX takes the first devices; a process outside a torch mesh
would have nothing to run).
"""

from __future__ import annotations

import datetime
import os
import typing as tp

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from . import comm

# torchrun's variables that say several processes were started
_LAUNCHER_ENV = ("WORLD_SIZE", "MASTER_ADDR", "TORCHELASTIC_RUN_ID")


def initialize_multihost(init_method: tp.Optional[str] = None,
                         world_size: tp.Optional[int] = None,
                         rank: tp.Optional[int] = None,
                         backend: tp.Optional[str] = None,
                         timeout_s: float = 600.0) -> bool:
    """Bring up the default process group; True when it is live.

    Without arguments the environment decides: torchrun sets `RANK`,
    `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR` and `MASTER_PORT`. A single
    process with none of them (or `WORLD_SIZE=1` alone) returns False: the
    plain single-process run, not an error. `backend` defaults to NCCL
    when a GPU is visible, else gloo; on NCCL the process's device is set
    to `cuda:LOCAL_RANK` first (`local_device`). When several processes
    were asked for and the handshake fails, raises RuntimeError instead of
    training alone."""
    if dist.is_available() and dist.is_initialized():
        return True
    env_world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    wants = any(a is not None for a in (init_method, world_size, rank)) \
        or env_world > 1 or any(os.environ.get(k)
                                for k in _LAUNCHER_ENV[1:])
    if not wants:
        return False
    world = int(world_size if world_size is not None else env_world)
    r = int(rank if rank is not None else os.environ.get("RANK", "0"))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    try:
        if not dist.is_available():
            raise RuntimeError("torch.distributed is not available")
        if backend == "nccl":
            torch.cuda.set_device(local_device())
        dist.init_process_group(
            backend, init_method=init_method or "env://", world_size=world,
            rank=r, timeout=datetime.timedelta(seconds=timeout_s))
    except Exception as e:
        raise RuntimeError(
            "initialize_multihost(): the process-group handshake failed but "
            f"{world} processes were requested (rank {r}, backend "
            f"{backend}): refusing to fall back to single-process "
            "training") from e
    return True


def local_device() -> torch.device:
    """`cuda:LOCAL_RANK`; raises when this rank cannot reach it (never a
    quiet move to another device or to the CPU)."""
    local = int(os.environ.get("LOCAL_RANK", "0") or 0)
    if not torch.cuda.is_available():
        raise RuntimeError(f"rank with LOCAL_RANK={local}: no CUDA device is "
                           "available")
    if local >= torch.cuda.device_count():
        raise RuntimeError(
            f"LOCAL_RANK={local} but this host has "
            f"{torch.cuda.device_count()} CUDA device(s)")
    return torch.device("cuda", local)


def _device_type(device_type: tp.Optional[str]) -> str:
    """The mesh's device type: NCCL's "cuda", gloo's "cpu" (a gloo mesh
    may still carry CUDA tensors; `comm` stages them through the host)."""
    if device_type is not None:
        return device_type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _need(n: int, what: str) -> None:
    avail = dist.get_world_size()
    if n > avail:
        raise ValueError(f"{what} needs {n} devices but only {avail} "
                         "are available")
    if n < avail:
        raise ValueError(f"{what} covers {n} of the world's {avail} "
                         "processes; a mesh spans the whole world")


def make_mesh(n_devices: tp.Optional[int] = None, axis_name: str = "data",
              device_type: tp.Optional[str] = None) -> DeviceMesh:
    """1-D mesh over the world's processes (`n_devices`: the world size,
    checked)."""
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    _need(n, f"make_mesh({n})")
    return init_device_mesh(_device_type(device_type), (n,),
                            mesh_dim_names=(axis_name,))


def make_mesh_2d(data: int, seq: int,
                 axis_names: tp.Tuple[str, str] = ("data", "seq"),
                 device_type: tp.Optional[str] = None) -> DeviceMesh:
    """2-D mesh, ranks row-major: `data` outer, the second axis inner."""
    _need(data * seq, f"make_mesh_2d({data}, {seq})")
    return init_device_mesh(_device_type(device_type), (data, seq),
                            mesh_dim_names=tuple(axis_names))


def make_hybrid_mesh(axis_names: tp.Tuple[str, ...],
                     ici_shape: tp.Tuple[int, ...],
                     dcn_shape: tp.Tuple[int, ...],
                     device_type: tp.Optional[str] = None) -> DeviceMesh:
    """Multi-host mesh: axis i holds `ici_shape[i] * dcn_shape[i]` ranks,
    the host (DCN) factor outermost, so an axis's heavy collectives stay
    within a host (NVLink) and only the `dcn`-factored axes cross hosts.
    torchrun numbers ranks host-major, so host h's ranks are a contiguous
    block; on one host (`dcn_shape` all ones) this is a row-major
    reshape."""
    if not len(axis_names) == len(ici_shape) == len(dcn_shape):
        raise ValueError("axis_names, ici_shape and dcn_shape differ in "
                         "length")
    n = int(np.prod(ici_shape)) * int(np.prod(dcn_shape))
    _need(n, f"make_hybrid_mesh({tuple(ici_shape)}, {tuple(dcn_shape)})")
    nd = len(axis_names)
    ranks = np.arange(n).reshape(tuple(dcn_shape) + tuple(ici_shape))
    # interleave (dcn_0, ici_0, dcn_1, ici_1, ...) then merge each pair
    ranks = ranks.transpose([a for i in range(nd) for a in (i, nd + i)])
    ranks = ranks.reshape(tuple(i * d for i, d in zip(ici_shape, dcn_shape)))
    return DeviceMesh(_device_type(device_type), torch.as_tensor(ranks),
                      mesh_dim_names=tuple(axis_names))


class BatchSharding(tp.NamedTuple):
    """Which rows of a global batch this rank holds: block `index` of
    `count` equal blocks along axis 0."""
    index: int
    count: int


def batch_sharding(mesh: DeviceMesh, axis_name: str = "data"
                   ) -> BatchSharding:
    """This rank's share of the leading (batch) axis over `axis_name`."""
    return BatchSharding(mesh.get_local_rank(axis_name),
                         mesh.size(mesh.mesh_dim_names.index(axis_name)))


def replicated(mesh: DeviceMesh, tree, axis_name: tp.Optional[str] = None):
    """Every tensor leaf of `tree` as the mesh's first rank holds it, on
    every rank (a broadcast over `axis_name`, or the whole mesh)."""
    from ..train.optim import tree_map

    group = (mesh.get_group(axis_name) if axis_name is not None
             else mesh.get_group() if mesh.ndim == 1 else None)
    return tree_map(lambda t: comm.broadcast(t, 0, group)
                    if isinstance(t, torch.Tensor) else t, tree)


def shard_batch(mesh: DeviceMesh, batch, axis_name: str = "data"):
    """This rank's rows `[r·b, (r+1)·b)` of a global batch (a tensor or a
    numpy array, batch axis first), `b = B / ranks`; B must divide."""
    index, count = batch_sharding(mesh, axis_name)
    B = batch.shape[0]
    if B % count:
        raise ValueError(f"global batch {B} is not divisible by the "
                         f"{count} ranks of mesh axis {axis_name!r}")
    b = B // count
    return batch[index * b:(index + 1) * b]
