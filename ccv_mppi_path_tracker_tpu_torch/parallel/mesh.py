"""The process group of sample-parallel MPPI (port of ``parallel/mesh.py``).

MPPI's one natural parallel axis is the K sample trajectories (the reference
runs them in a serial C++ loop, src/diff_drive_mppi.cpp:92-124). Here each
process of a ``torch.distributed`` group is one shard of that axis, and the
whole communication of an update is an all-reduce MIN of the baseline and
all-reduce SUMs of the normalizer and the update (ops/softmax_update.py).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

# the name of the sample axis, as in the JAX package's mesh
SAMPLES_AXIS = "samples"


def samples_group(device=None):
    """(group, device) of this process: the process group of the sample
    shards, which is the default group of the launch, and the device this
    rank runs on: ``cuda:{local_rank}`` by default, with the local rank from
    ``LOCAL_RANK`` (set by ``torchrun``) or else the global rank. Call after
    :func:`parallel.multihost.initialize_multihost`."""
    if device is None:
        local_rank = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        device = torch.device("cuda", local_rank)
    return dist.group.WORLD, torch.device(device)
