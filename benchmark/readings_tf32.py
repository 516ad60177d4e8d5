"""The readings with a second control for a configuration whose guarantees
say "no TF32": the port with TF32 allowed for float32 matrix products while
its update runs, is captured and replays (``TF32``), beside the programs of
``benchmark.readings``.

    python3 -m benchmark.readings_tf32 --workload autorally_nn.update \\
        --seeds 1,2,3 --seconds 2 --program tf32

A CUDA graph keeps the matrix products' kernels chosen at its capture, so
the captured update runs in TF32 at every replay; TF32 is off again before
the check (``restore``), where the reference computes in float32. The
benchmark's own runs never run this program.
"""

from __future__ import annotations

import sys

import torch

from benchmark import readings
from benchmark.programs import Port


def _allow(on: bool):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


class TF32(Port):
    def update_step(self):
        step = super().update_step()

        def tf32(*args):
            _allow(True)
            try:
                return step(*args)
            finally:
                _allow(False)
        return tf32

    def restore(self):
        _allow(False)


if __name__ == "__main__":
    readings.PROGRAMS["tf32"] = TF32
    sys.exit(readings.main())
