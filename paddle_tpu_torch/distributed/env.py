"""Multi-process runtime bootstrap: the PADDLE_* env contract (or
torchrun's RANK/WORLD_SIZE) -> a torch.distributed process group.

Reference: the NCCL/gRPC bootstrap in operators/distributed + the
launcher's env contract. The JAX package runs one process per host and
wires it into JAX's distributed runtime; the port runs one process per
card, as the reference did, and each process is one rank of a
torch.distributed group.

    import paddle_tpu_torch.distributed as dist
    dist.init_parallel_env()          # reads PADDLE_TRAINER_* env
    mesh = dist.global_mesh({"dp": -1})

The backend is explicit: NCCL by default where CUDA is present, gloo only
when the caller names it (`backend="gloo"`, or
PADDLE_DISTRI_BACKEND=gloo). There is no silent switch from one to the
other. At world size 1 no group is made.
"""
from __future__ import annotations

import datetime
import os

import numpy as np

__all__ = ["init_parallel_env", "global_mesh", "parallel_env_rank",
           "parallel_env_world_size"]

_init_args = None  # (init_method, world size, rank, backend) after init


def _env_int(*names, default):
    for n in names:
        if os.environ.get(n, "") != "":
            return int(os.environ[n])
    return default


def parallel_env_rank() -> int:
    if _init_args is not None:
        return _init_args[2]
    return _env_int("PADDLE_TRAINER_ID", "RANK", default=0)


def parallel_env_world_size() -> int:
    if _init_args is not None:
        return _init_args[1]
    return _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE", default=1)


def init_parallel_env(init_method=None, world_size=None, rank=None,
                      backend=None, timeout_s=600.0):
    """Join this process to the job's process group.

    Defaults come from the launcher's env contract
    (PADDLE_TRAINER_ENDPOINTS / PADDLE_TRAINERS_NUM / PADDLE_TRAINER_ID)
    or torchrun's (MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK): the
    rendezvous is trainer 0's endpoint. Single-process jobs (world size
    1) make no group. Each rank binds the card LOCAL_RANK (default its
    rank) when the backend is NCCL.
    """
    global _init_args
    import torch
    import torch.distributed as dist
    n = world_size if world_size is not None else parallel_env_world_size()
    if n <= 1:
        # single process: not recorded, so a later call with real
        # multi-process arguments still works
        return
    r = rank if rank is not None else parallel_env_rank()
    if backend is None:
        backend = os.environ.get("PADDLE_DISTRI_BACKEND") or (
            "nccl" if torch.cuda.is_available() else None)
    if backend not in ("nccl", "gloo"):
        raise RuntimeError(
            "init_parallel_env: no CUDA device, so there is no NCCL; "
            "name the backend (backend='gloo') to run on the host")
    if init_method is None:
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        if eps:
            init_method = f"tcp://{eps.split(',')[0]}"
        elif os.environ.get("MASTER_ADDR"):
            init_method = "env://"
        else:
            raise RuntimeError(
                "init_parallel_env: PADDLE_TRAINER_ENDPOINTS is not set "
                "and no init_method was given — run under python -m "
                "paddle_tpu_torch.distributed.launch or pass it")
    args = (init_method, n, r, backend)
    if _init_args is not None:
        if _init_args != args:
            raise RuntimeError(
                f"init_parallel_env: already initialized as "
                f"{_init_args}, cannot re-initialize as {args}")
        return
    if backend == "nccl":
        torch.cuda.set_device(_env_int("LOCAL_RANK", default=r)
                              % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method, world_size=n, rank=r,
        timeout=datetime.timedelta(seconds=timeout_s))
    _init_args = args


def global_mesh(axes, devices=None):
    """A Mesh over every rank of the job. `axes` is an ordered
    {name: size} dict; one size may be -1 (inferred)."""
    from ..parallel.mesh import Mesh, world
    ranks = np.asarray(devices if devices is not None
                       else np.arange(world()[0]))
    sizes = list(axes.values())
    n_infer = sum(1 for s in sizes if s == -1)
    if n_infer > 1:
        raise ValueError("global_mesh: at most one axis size may be -1")
    known = int(np.prod([s for s in sizes if s != -1])) or 1
    if n_infer:
        if ranks.size % known:
            raise ValueError(
                f"global_mesh: {ranks.size} ranks not divisible by "
                f"{known}")
        sizes = [ranks.size // known if s == -1 else s for s in sizes]
    if int(np.prod(sizes)) != ranks.size:
        raise ValueError(
            f"global_mesh: axes {dict(zip(axes, sizes))} need "
            f"{int(np.prod(sizes))} ranks, job has {ranks.size}")
    return Mesh(ranks.reshape(sizes), tuple(axes.keys()))
