"""Chain-parallel execution over a ``torch.distributed`` device mesh.

The reference's only parallelism is single-process chain vectorization; the
scaling axis here is the same chain dimension *sharded over devices*, as in
``nfmc_tpu.parallel``. The JAX package runs one program over its mesh and
lets GSPMD insert the reductions. PyTorch runs one process a device, as
under ``torchrun``, so this module ports the contract, not the mechanism:

* the mesh is a ``DeviceMesh``; chains shard over its **first** axis,
  whatever its name, and the other axes replicate;
* each rank runs the sampler on its own rows as plain local tensors (no
  DTensor inside the loop: the port is host-bound and the CUDA kernels have
  no sharding rules), and the few points where chains meet reduce over the
  first axis's process group (:mod:`nfmc_torch.core.chains`);
* results equal the unsharded run's: bit for bit on one rank, up to the
  order of float sums across ranks.

Run one process a device, e.g. ``torchrun --nproc-per-node 4 run.py`` with::

    import os
    import torch
    from nfmc_torch.parallel import chain_mesh, sharded_sample

    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    torch.distributed.init_process_group("nccl")
    mesh = chain_mesh()
    out = sharded_sample(sampler, x0, mesh=mesh, seed=0, show_progress=False)
    # out.samples: (n_iterations, n_chains, *event) on every rank

or ``chain_mesh()`` alone in one process on one card (it starts a one-rank
NCCL group).
"""
from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from typing import Optional

import torch

from ..core.chains import is_sharded, mesh_device

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _start_single_rank_group(device_type: str) -> None:
    """A one-rank process group over a ``FileStore`` in a temporary
    directory: no network address is needed."""
    import torch.distributed as dist

    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a 'cuda' mesh needs a CUDA device; pass device_type='cpu' "
                               "for a gloo group on the CPU")
        torch.cuda.set_device(torch.cuda.current_device())
    tmp = tempfile.mkdtemp(prefix="nfmc-mesh-")
    atexit.register(shutil.rmtree, tmp, True)
    store = dist.FileStore(os.path.join(tmp, "store"), 1)
    dist.init_process_group(_BACKENDS[device_type], store=store, rank=0, world_size=1)


def chain_mesh(n_devices: Optional[int] = None, axis_name: str = "chains",
               device_type: Optional[str] = None):
    """1-D ``DeviceMesh`` over the (first ``n_devices``) ranks of the
    process group; chain axis sharded over it.

    ``device_type`` is ``"cuda"`` (the default; NCCL) or ``"cpu"`` (gloo):
    the running group must have that backend. Without a process group and
    with one rank asked for, it starts a one-rank group itself; tear it
    down with ``torch.distributed.destroy_process_group()``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    device_type = device_type or "cuda"
    if device_type not in _BACKENDS:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    if not dist.is_initialized():
        if n_devices is not None and n_devices > 1:
            # silently truncating would run at less parallelism than the
            # caller configured
            raise ValueError(f"requested n_devices={n_devices} but only 1 devices are available "
                             "(no process group: start one process a device, e.g. torchrun)")
        _start_single_rank_group(device_type)
    backend = str(dist.get_backend())
    if _BACKENDS[device_type] not in backend:
        raise ValueError(f"a {device_type!r} mesh needs the {_BACKENDS[device_type]} backend, "
                         f"but the process group runs {backend}")
    world = dist.get_world_size()
    if n_devices is not None and n_devices > world:
        raise ValueError(f"requested n_devices={n_devices} but only {world} devices are available")
    n = world if n_devices is None else int(n_devices)
    return DeviceMesh(device_type, list(range(n)), mesh_dim_names=(axis_name,))


def _axis_index(mesh, axis_name: str) -> int:
    names = mesh.mesh_dim_names
    if names is None:
        return 0
    if axis_name not in names:
        raise ValueError(f"mesh has no axis {axis_name!r} (axes {names})")
    return names.index(axis_name)


def shard_chains(x, mesh, axis_name: str = "chains"):
    """``(n_chains, ...)`` as a DTensor of that global shape, its chain axis
    sharded (``Shard(0)``) over the mesh axis ``axis_name`` and replicated
    over the others. Each rank keeps its rows of its own copy of ``x`` (the
    ranks hold the same ``x``, drawn from one seed): nothing is sent."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    x = torch.as_tensor(x, device=mesh_device(mesh))
    dim = _axis_index(mesh, axis_name)
    size = mesh.size(dim)
    if x.shape[0] % size != 0:
        raise ValueError(f"n_chains={x.shape[0]} must be divisible by the '{axis_name}' "
                         f"mesh axis size {size}")
    b = x.shape[0] // size
    local = x.narrow(0, mesh.get_local_rank(dim) * b, b)
    placements = [Replicate()] * mesh.ndim
    placements[dim] = Shard(0)
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=x.shape,
                              stride=x.contiguous().stride())


def replicate(tree, mesh):
    """A tree (nested dicts, lists, tuples) of arrays (e.g. flow or kernel
    params) as DTensors replicated over the mesh."""
    from torch.distributed.tensor import DTensor, Replicate

    device = mesh_device(mesh)

    def rep(node):
        if isinstance(node, dict):
            return {k: rep(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rep(v) for v in node)
        t = torch.as_tensor(node, device=device)
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)

    return rep(tree)


def constrain_chains(x, mesh, axis_name: str = "chains"):
    """Pin the chain axis of a DTensor to the mesh axis ``axis_name``
    (redistributing it to ``Shard(0)`` there, replicated elsewhere); the
    identity on a local tensor, which is already this rank's rows."""
    if not is_sharded(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    placements = [Replicate()] * mesh.ndim
    placements[_axis_index(mesh, axis_name)] = Shard(0)
    return x.redistribute(mesh, placements)


def sharded_sample(sampler, x0, mesh=None, **kwargs):
    """Run ``sampler.sample`` with chains sharded over the first axis of
    ``mesh`` (default: :func:`chain_mesh` on the sampler's device type).

    The chain axis of ``x0`` must divide that axis's size. Each rank runs
    its rows with the axis's process group; the returned output holds the
    global chains on every rank, gathered in rank order, and statistics
    summed over the ranks."""
    if mesh is None:
        mesh = chain_mesh(device_type=sampler.device.type)
    names = mesh.mesh_dim_names
    axis_name = names[0] if names else "0"
    axis_size = mesh.size(0)
    n_chains = tuple(x0.shape)[0]
    if n_chains % axis_size != 0:
        raise ValueError(f"n_chains={n_chains} must be divisible by the '{axis_name}' "
                         f"mesh axis size {axis_size}")
    if not is_sharded(x0):
        x0 = shard_chains(x0, mesh, axis_name=axis_name)
    return sampler.sample(x0, **kwargs)
