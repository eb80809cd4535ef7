"""The device mesh of the port on torch.distributed (vch_tpu/parallel/mesh.py).

vch_tpu drives a whole `jax.sharding.Mesh` from one program; the port runs
one process per device (a rank), each holding its own block of every
sharded array, with NCCL between CUDA devices and gloo between CPU
processes. The mesh is a `torch.distributed.device_mesh.DeviceMesh` over
the world's ranks: a 1D mesh over the scenario batch ("scenarios"), or the
combined ("scenarios", "gx") mesh of the grid-sharded batched problem
(parallel/spatial.py). An array whose leading axis is the batch is placed
`Shard(0)`: rank r of D holds members [r B/D, (r+1) B/D).

`initialize_distributed` makes the process group: from its arguments, else
from the variables `torchrun` sets (RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT, LOCAL_RANK), else a world of size 1 on a FileStore in a
temporary directory, so that a mesh works on one device with no launcher.
"""
from __future__ import annotations

import atexit
import datetime
import os
import shutil
import tempfile
from typing import Optional, Sequence

import torch
import torch.distributed as dist

BATCH_AXIS = "scenarios"


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def _device_type(device) -> str:
    """The mesh's device type: `device` (a torch.device or its name), None
    meaning the CUDA card (vch_tpu_torch.device.resolve_device)."""
    from vch_tpu_torch.device import resolve_device
    return resolve_device(device).type


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device=None, timeout: Optional[float] = None):
    """Make the default process group (vch_tpu's `jax.distributed.initialize`
    wrapper); True when this call made it, False when it was not made
    (one exists already, or the rendezvous failed; the reason is printed).

    coordinator_address: "host:port" (a TCP rendezvous) or an init-method
    URL ("tcp://...", "file://..."); num_processes, process_id: the world
    size and this process's rank. Missing ones are read from torchrun's
    variables; with none of them, a world of size 1 on a FileStore in a
    temporary directory. The backend is NCCL for a CUDA device (None: the
    card) and gloo for the CPU; on CUDA the process takes the card
    LOCAL_RANK (default 0), so `resolve_device(None)` is its own.
    timeout: seconds a collective may wait before it fails (torch's
    default when None)."""
    if dist.is_initialized():
        print("[parallel] distributed init skipped: a process group "
              "exists already")
        return False
    dtype = _device_type(device)
    env = os.environ
    world = num_processes if num_processes is not None else (
        int(env["WORLD_SIZE"]) if "WORLD_SIZE" in env else None)
    rank = process_id if process_id is not None else (
        int(env["RANK"]) if "RANK" in env else None)
    if coordinator_address is not None:
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
    elif "MASTER_ADDR" in env and "MASTER_PORT" in env:
        init = "env://"
    else:
        init = None
    if init is None and (world or 1) == 1:
        tmp = tempfile.mkdtemp(prefix="vch_dist_")
        atexit.register(shutil.rmtree, tmp, ignore_errors=True)
        init, world, rank = f"file://{os.path.join(tmp, 'store')}", 1, 0
    if dtype == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    try:
        dist.init_process_group(_backend(dtype), init_method=init,
                                world_size=-1 if world is None else world,
                                rank=-1 if rank is None else rank, **kw)
    except Exception as e:          # no rendezvous: the caller decides
        print(f"[parallel] distributed init skipped: {e}")
        return False
    return True


def world_size(device=None) -> int:
    """The world's size, making the process group first if nobody has
    (initialize_distributed); raises when none can be made: a mesh that was
    asked for never falls back to no mesh."""
    if not dist.is_initialized():
        initialize_distributed(device=device)
    if not dist.is_initialized():
        raise RuntimeError("a device mesh needs a torch.distributed process "
                           "group and none could be made")
    return dist.get_world_size()


def _world_mesh(device, shape: Sequence[int], names: Sequence[str],
                ranks=None):
    """A DeviceMesh of `shape` over `ranks` (default: the whole world, which
    the shape must cover), initializing the process group first if nobody
    has; raises when none can be made."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    dtype = _device_type(device)
    world_size(dtype)
    if dist.get_backend() != _backend(dtype):
        raise ValueError(f"the process group's backend is "
                         f"{dist.get_backend()}; a {dtype} mesh needs "
                         f"{_backend(dtype)}")
    n = 1
    for s in shape:
        n *= s
    if ranks is None:
        if n != dist.get_world_size():
            raise ValueError(f"a mesh of shape {tuple(shape)} needs a world "
                             f"of {n} ranks; this one has "
                             f"{dist.get_world_size()}")
        return init_device_mesh(dtype, tuple(shape),
                                mesh_dim_names=tuple(names))
    ranks = torch.as_tensor(list(ranks), dtype=torch.int64)
    if ranks.numel() != n:
        raise ValueError(f"{ranks.numel()} ranks do not fill a mesh of "
                         f"shape {tuple(shape)}")
    return DeviceMesh(dtype, ranks.reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence[int]] = None, device=None):
    """1D mesh over the scenario-batch axis: every rank of the world, or
    the ranks `devices`; n_devices, when given, must equal their count
    (each rank is one device). device: the mesh's device type (None: the
    CUDA card). Makes the process group first if nobody has."""
    if devices is None:
        size = world_size(device)
        if n_devices is not None and n_devices != size:
            raise ValueError(f"n_devices={n_devices}: the port runs one "
                             f"process per device and this world has {size}"
                             f"; launch {n_devices} ranks (torchrun)")
        return _world_mesh(device, (size,), (BATCH_AXIS,))
    devices = list(devices)
    if n_devices is not None and n_devices != len(devices):
        raise ValueError(f"n_devices={n_devices} but {len(devices)} devices")
    return _world_mesh(device, (len(devices),), (BATCH_AXIS,), ranks=devices)


def check_mesh(mesh):
    """`mesh` if it is a DeviceMesh with named dimensions, else TypeError
    or ValueError."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(parallel.mesh.make_mesh); got "
                        f"{type(mesh).__name__}")
    if not mesh.mesh_dim_names:
        raise ValueError("mesh needs named dimensions (mesh_dim_names)")
    return mesh


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def batch_sharding(mesh):
    """The placement of an array whose leading axis is the scenario batch
    (vch_tpu's NamedSharding(P("scenarios"))): Shard(0) on the mesh's
    scenario dimension, Replicate() on any other."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(0) if a == BATCH_AXIS else Replicate()
                 for a in mesh.mesh_dim_names)


def replicated_sharding(mesh):
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def local_block(n: int, shards: int, index: int) -> slice:
    """Rows [index n/shards, (index+1) n/shards) of n; raises unless
    shards divides n."""
    if n % shards:
        raise ValueError(f"{n} does not divide into {shards} equal blocks")
    k = n // shards
    return slice(index * k, (index + 1) * k)


def place_block(a, mesh, placements):
    """This rank's block of `a` under `placements`, one per mesh dimension:
    a dimension placed Shard(d) cuts axis d of `a` into equal blocks, one
    per rank along it; Replicate() leaves it whole. Raises where a block
    would not be whole."""
    from torch.distributed.tensor import Shard
    for ax, p in zip(mesh.mesh_dim_names, placements):
        if isinstance(p, Shard):
            blk = local_block(a.shape[p.dim], axis_size(mesh, ax),
                              axis_rank(mesh, ax))
            a = a[(slice(None),) * p.dim + (blk,)]
    return a


def shard_batch(tree, mesh):
    """This rank's block of the leading axis of every array in `tree` (a
    tensor or numpy array, None, or a tuple / list / dict of them): rank r
    of D holds [r B/D, (r+1) B/D), as a NamedSharding(P("scenarios"))
    places it on device r (vch_tpu). Raises unless D divides B."""
    placements = batch_sharding(mesh)

    def take(a):
        if a is None:
            return None
        if isinstance(a, (tuple, list)):
            out = [take(x) for x in a]
            return (type(a)(*out) if hasattr(a, "_fields")
                    else type(a)(out))
        if isinstance(a, dict):
            return {k: take(v) for k, v in a.items()}
        return place_block(a, mesh, placements)

    return take(tree)


def all_gather_dim(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The blocks of `t` of every rank of `group`, concatenated along `dim`
    in rank order (each rank's block the same shape); `t` itself in a
    group of one."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)
