"""Process-group set-up for the env-batch split: one process a GPU.

The JAX package runs one process over every chip of a host and lets GSPMD
place the shards; PyTorch runs one process a card over
``torch.distributed``.  This module holds the pieces that set that up:

* ``init_distributed(backend, ...)``: join the process group and return the
  ``"envs"`` mesh of every rank.  ``"nccl"`` when each rank has a card of
  its own, ``"gloo"`` on the CPU or for ranks that share a card (gloo
  carries CUDA tensors through the host).  Ranks exchange the identity of
  their devices through the rendezvous store before the backend starts,
  and NCCL with two ranks on one device raises ``ValueError`` on every
  rank: it is not switched to gloo behind the caller's back.  A rank's
  device is ``cuda:{LOCAL_RANK}`` unless the caller names one;
* ``run_workers(commands, timeout)``: start one process a rank and wait for
  all; the first that fails, or the timeout, stops the others and raises,
  so a failed worker fails the whole run;
* ``free_port()``: a free TCP port on ``localhost`` for ``tcp://``
  rendezvous.

Under ``python -m torch.distributed.run`` the rank, world size and local
rank come from the environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), and ``init_method`` defaults to
``env://``.
"""
from __future__ import annotations

import datetime
import os
import socket
import subprocess
import tempfile
import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from vectorizedmultiagentsimulator_tpu_torch.parallel.sharding import (
    EnvMesh,
    make_mesh,
)

DEFAULT_TIMEOUT_S = 300.0
_DEVICE_KEY = "vmt_device_{}"
_READ_KEY = "vmt_devices_read_{}"


def free_port() -> int:
    """A TCP port on ``localhost`` that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def device_identity(device: torch.device) -> str:
    """What tells two devices apart across processes and hosts: the card's
    UUID for a CUDA device, else the host's name and the device."""
    host = socket.gethostname()
    if device.type == "cuda" and torch.cuda.is_available():
        index = device.index if device.index is not None else 0
        return f"{host}/{torch.cuda.get_device_properties(index).uuid}"
    return f"{host}/{device}"


def init_distributed(backend: str, rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     init_method: Optional[str] = None, device=None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> EnvMesh:
    """Join the default process group over ``backend`` and return the mesh
    of its ranks, on this rank's device (``cuda:{LOCAL_RANK}``, or
    ``device``).  ``rank`` and ``world_size`` default to ``RANK`` and
    ``WORLD_SIZE``; ``init_method`` to ``env://``."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}"
    device = torch.device(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    store, rank, world_size = next(dist.rendezvous(
        init_method or "env://", rank=rank, world_size=world_size,
        timeout=timeout))
    store.set(_DEVICE_KEY.format(rank), device_identity(device))
    if backend == "nccl":
        ids = [store.get(_DEVICE_KEY.format(r)).decode()
               for r in range(world_size)]
        store.set(_READ_KEY.format(rank), "1")
        shared = sorted({i for i in ids if ids.count(i) > 1})
        if shared:
            ranks = [r for r, i in enumerate(ids) if i in shared]
            # Rank 0 hosts the store: it stays until every rank has read
            # the identities, so each raises this error rather than losing
            # the store mid-read.
            if rank == 0:
                store.wait([_READ_KEY.format(r) for r in range(world_size)])
            raise ValueError(
                f"NCCL takes one rank a device, but ranks {ranks} share"
                f" {shared}: give each rank a card of its own, or use"
                " backend='gloo'")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, timeout=timeout)
    return make_mesh(device=device)


def run_workers(commands: Sequence[Sequence[str]], timeout_s: float,
                env=None, cwd=None) -> List[str]:
    """Run each command as a process, all at once; returns their outputs
    (standard output and error together).  If one exits with another code
    than 0, or ``timeout_s`` passes first, the others are killed and
    ``RuntimeError`` carries the end of every output."""
    logs = [tempfile.TemporaryFile(mode="w+") for _ in commands]
    procs = [subprocess.Popen(list(c), stdout=f, stderr=subprocess.STDOUT,
                              env=env, cwd=cwd, text=True)
             for c, f in zip(commands, logs)]
    deadline = time.monotonic() + timeout_s
    failure = None
    try:
        while failure is None:
            codes = [p.poll() for p in procs]
            bad = [i for i, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failure = f"worker {bad[0]} exited {codes[bad[0]]}"
            elif None not in codes:
                break
            elif time.monotonic() > deadline:
                failure = f"the workers took more than {timeout_s} s"
            else:
                time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    outputs = []
    for f in logs:
        f.seek(0)
        outputs.append(f.read())
        f.close()
    if failure is not None:
        tails = "\n".join(f"--- worker {i} ---\n{out[-3000:]}"
                          for i, out in enumerate(outputs))
        raise RuntimeError(f"{failure}\n{tails}")
    return outputs
