"""Process-group bring-up and the rank's place in it.

Counterpart of `video_rep_learning_tpu/parallel/mesh.py::init_distributed`
and `is_root_proc` (the reference's `init_process_group`,
`train.py:259-262`). The JAX package's `create_mesh`, `shard_batch`,
`replicate` and `data_axis_size` have no counterpart: each rank holds its
own replica, and DDP broadcasts rank 0's parameters when it wraps the
model.
"""

from __future__ import annotations

import datetime
import os
from contextlib import contextmanager
from typing import Optional, Tuple

import torch
import torch.distributed as dist

# how long a collective waits for a peer before it fails (the rank whose
# peer died raises instead of hanging); an evaluation that rank 0 runs alone
# must fit in it
DEFAULT_TIMEOUT_S = 1800.0


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device="cuda",
                     backend: Optional[str] = None,
                     timeout: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group at `tcp://<coordinator>` (host:port) as rank
    `process_id` of `num_processes`, and return the rank's device: for
    `cuda`, card `process_id % device_count`, made the current card. The
    backend follows the device (NCCL on cards, gloo on the CPU) unless
    `backend` says otherwise. Unless OMP_NUM_THREADS is set, a rank of
    several takes its share of this process's CPUs as intra-op threads:
    ranks that each start a thread a CPU contend for them (torchrun sets
    one thread a rank for the same reason). Without a coordinator nothing
    is joined and `device` comes back as given."""
    device = torch.device(device)
    if coordinator is None:
        return device
    if num_processes is None or process_id is None:
        raise ValueError("--coordinator needs --num_processes and --process_id")
    if num_processes > 1 and "OMP_NUM_THREADS" not in os.environ:
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // num_processes))
    if device.type == "cuda":
        device = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"),
        init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout))
    return device


@contextmanager
def process_group(coordinator: Optional[str], num_processes: Optional[int],
                  process_id: Optional[int], device="cuda"):
    """`init_distributed` for the body of an entry point, which gets the
    rank's device; the group it joined is left when the body ends. A body
    that raises leaves it to the process's exit: tearing down a group whose
    peer died can wait on that peer."""
    device = init_distributed(coordinator, num_processes, process_id, device)
    yield device
    if coordinator is not None:
        dist.destroy_process_group()


def world() -> Tuple[int, int]:
    """(world size, rank), (1, 0) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def is_root_proc() -> bool:
    return world()[1] == 0


def check_parallel_config(cfg) -> None:
    """The JAX package's tensor and sequence parallelism (a 2-D mesh,
    head-sharded attention, Ulysses all-to-alls; `parallel/sharding.py`)
    go beyond the reference's data parallelism and are not ported."""
    tp = int(cfg.PARALLEL.TENSOR_PARALLELISM or 1)
    if tp > 1:
        raise NotImplementedError(
            f"PARALLEL.TENSOR_PARALLELISM {tp} (head-parallel attention"
            + (", Ulysses sequence parallelism" if cfg.PARALLEL.SEQUENCE_PARALLELISM
               else "") + ") comes with ROADMAP queue 1 item 6b; the port runs "
            "data parallelism, one process per card")
