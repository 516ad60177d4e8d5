"""Joining the processes of a sharded run (port of ``parallel/multihost.py``).

Every process runs the same program; ``torch.distributed`` joins them into
one group, over NCCL on the card and gloo on the CPU. A solver that quietly
computed on 1/N of its samples would be the worst failure this controller
has, so a configured launch that fails to join raises: there is no silent
drop to one process.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = 300.0,
) -> bool:
    """Join the process group when a distributed launch is configured.

    coordinator_address: "host:port" of rank 0's store (default
    ``MASTER_ADDR``:``MASTER_PORT``, as ``torchrun`` sets them);
    num_processes and process_id default to ``WORLD_SIZE`` and ``RANK``.
    backend: "nccl" where CUDA is available, else "gloo" (pass "gloo" to
    run several ranks on one card). Returns True once the group is up (or
    was already), False when no launch is configured: no argument and none
    of ``MASTER_ADDR``/``WORLD_SIZE`` set. Raises RuntimeError when one is
    configured and the join fails within ``timeout_s``.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None and process_id is None:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    try:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("a launch needs the coordinator address, the number of "
                             "processes and this process's id")
        address = coordinator_address.removeprefix("tcp://")
        dist.init_process_group(
            backend, init_method=f"tcp://{address}", world_size=num_processes,
            rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    except Exception as e:
        raise RuntimeError(
            f"distributed launch configured (coordinator={coordinator_address!r}, "
            f"num_processes={num_processes}, process_id={process_id}, "
            f"backend={backend!r}) but joining the process group failed; refusing "
            f"to run as one process. Unset MASTER_ADDR and WORLD_SIZE to run "
            f"unsharded") from e
    return True
