"""Multi-device runtime on `torch.distributed`: the process group, a 1-D
mesh over it, and the sharded MSM.

Counterpart of `ark_blst_tpu/distributed.py` (`initialize`, `global_mesh`,
`msm_distributed`). Where the JAX package runs one program over a mesh of
devices (`shard_map`), the port runs one process per rank, each owning one
device. Every sharded entry (`msm_distributed`,
`curves/msm_bucket.py:msm_sharded2`, `curves/msm.py:msm_sharded`,
`curves/pairing.py:multi_pairing_sharded`) is a collective: every rank of
the mesh calls it with the same global inputs, takes its contiguous shard
of the last axis (the shard `PartitionSpec(None, axis)` gives device r),
runs the single-device pipeline on it, gathers the ranks' small partials
(stacked window sums, or one fp12 each), folds them in rank order and
finishes, so every rank returns the same result.

    # on every rank, one process each
    initialize("10.0.0.1:29500", num_processes=world, process_id=rank)
    mesh = global_mesh()
    out = msm_distributed(points, scalars, mesh=mesh)

The backend is NCCL for CUDA and gloo for the CPU unless the caller names
one. Two ranks on one card need gloo (NCCL refuses two ranks on one
device); a world of one still runs the collectives.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .curves import msm_bucket as MB
from .curves.group import G1, CurveOps
from .curves.msm import msm_sharded
from .device import resolve_device
from .ops.tower import tree_map

_device = None  # this rank's device, set by `initialize`


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, device="cuda", backend: str | None = None) -> None:
    """Join (or form) the process group, `torch.distributed.init_process_group`.

    `coordinator_address` is "host:port" (a `tcp://` rendezvous that rank 0
    serves) or any init URL; None reads MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE and RANK from the environment (`env://`), as a launcher such
    as torchrun sets them. `device` is where this rank runs: "cuda" takes
    `cuda:{LOCAL_RANK}` where that is set, else `cuda:{rank % cards}`; an
    indexed device is taken as given; CUDA without a card raises. `backend`
    defaults to NCCL for CUDA and gloo for the CPU, and is never changed
    behind the caller's back. Idempotent within a process: a second call
    returns at once."""
    global _device
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = "tcp://" + coordinator_address
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)
    if dev.type == "cuda":
        if torch.device(device).index is None:
            local = os.environ.get("LOCAL_RANK")
            index = int(local) if local is not None else dist.get_rank() % torch.cuda.device_count()
            dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    _device = dev


@dataclass
class Mesh:
    """A 1-D mesh over a process group: its axis name, the group, this
    rank's place and device, the backend, and how many of the mesh's ranks
    share this rank's device (`sharing`; each then plans its memory from
    its share). Counts its gathers and the bytes each rank received
    (`gathers`, `gather_bytes`)."""

    axis: str
    group: object
    rank: int
    size: int
    device: torch.device
    backend: str
    sharing: int = 1
    gathers: int = 0
    gather_bytes: int = 0

    @property
    def shape(self) -> dict:
        """Axis name -> size, as a JAX mesh's `shape` reads."""
        return {self.axis: self.size}

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` (one shape on all ranks) stacked in rank order,
        (size, *t.shape), on t's device. gloo carries CUDA tensors through
        host memory; the partials gathered here are a few KB."""
        src = t.contiguous()
        if self.backend == "gloo":
            src = src.cpu()
        out = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(out, src, group=self.group)
        self.gathers += 1
        self.gather_bytes += self.size * src.numel() * src.element_size()
        return torch.stack(out).to(t.device)

    def all_gather_tree(self, tree):
        """Every tensor of a nested tuple (one structure, one shape per leaf on
        all ranks) in one gather: each leaf (L, *b) -> (L, size, *b), the
        ranks in order on the axis after the first."""
        leaves = []
        tree_map(leaves.append, tree)
        got = iter(self.all_gather(torch.stack(leaves)).movedim(0, 2).unbind(0))
        return tree_map(lambda _: next(got), tree)


def global_mesh(axis: str = "data") -> Mesh:
    """1-D mesh named `axis` over every rank of the process group, one
    device each (`initialize` first). A collective: it exchanges each
    rank's host and device to count the ranks that share a device. The
    mesh is a small dataclass rather than a `DeviceMesh`, whose device type
    is tied to one backend: two ranks on one card run gloo on CUDA
    tensors."""
    if not dist.is_initialized() or _device is None:
        raise RuntimeError("no process group: call initialize(...) first")
    group = dist.group.WORLD
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    where = [None] * size
    dist.all_gather_object(where, (socket.gethostname(), str(_device)), group=group)
    return Mesh(axis, group, rank, size, _device, dist.get_backend(group),
                sharing=where.count(where[rank]))


def msm_distributed(points, scalars, curve: CurveOps = G1, c: int | None = None,
                    lanes: int = 1024, mesh: Mesh | None = None, axis: str = "data",
                    backend: str | None = None, max_windows: int | None = None,
                    finish: str = "device"):
    """MSM with the points sharded over the mesh (default: `global_mesh`),
    a collective; inputs and result as for `curves/msm.py:msm`.

    backend: None chooses "pallas" when the mesh is on CUDA and "scan"
    otherwise, the JAX package's rule with the card in the TPU's place.
    "pallas" keeps the JAX name and here means the bucket kernels, K2 or
    K2-G2 on every rank (`msm_bucket.msm_sharded2`, c default 7 or 5,
    `max_windows`); "scan" the strict engine's scan MSM
    (`msm.msm_sharded`, K7-K10 on the card, c default 8, `lanes` default
    1024 as `msm`'s, `finish`)."""
    if mesh is None:
        mesh = global_mesh(axis)
    if backend is None:
        backend = "pallas" if mesh.device.type == "cuda" else "scan"
    if backend == "pallas":
        kc = MB.KC2_G2 if curve.name == "g2" else MB.KC2_G1
        return MB.msm_sharded2(points, scalars, mesh, kc, c=c, axis=axis,
                               max_windows=max_windows)
    if backend != "scan":
        raise ValueError(f"backend is 'pallas' or 'scan', not {backend!r}")
    return msm_sharded(points, scalars, mesh, curve, c=8 if c is None else c, lanes=lanes,
                       axis=axis, finish=finish)
