"""The differentiable side's compiled programs: a functional Adam and the
:class:`Program` that runs a training step as ``lax.scan`` runs it.

Each training program of diff/ (the system-ID fits, the sampler fit,
meta-training) is one pure step ``(carry, *fixed) -> (carry, loss)`` whose
carry holds the parameters and the Adam state as plain tensors, gradients
from ``torch.func.grad_and_value`` inside the step. On the card
:class:`Program` scans it through ``utils/cuda_graph.Graphed.scan`` (one
capture, then one replay a step, the losses stacked on the device with no
host read inside the loop), elsewhere through ``utils/cuda_graph.scan``, the
same function run eagerly. ``torch.optim.Adam`` does not fit there: by
default it keeps its step count on the host, which a replay would freeze in
the bias correction, and with ``capturable=True`` its state lives outside
the carry, where ``Graphed.scan`` cannot carry it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ccv_mppi_path_tracker_tpu_torch.utils.cuda_graph import Graphed, scan, split_tensors


def adam_init(params):
    """The Adam state of the tensors ``params``: (mu, nu, count), zero
    moments like each parameter and a 0-d int64 step count on their device
    (``optax.adam``'s ``init``)."""
    return (tuple(torch.zeros_like(p) for p in params),
            tuple(torch.zeros_like(p) for p in params),
            torch.zeros((), dtype=torch.int64, device=params[0].device))


def adam_update(params, grads, state, lr: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8):
    """One Adam step of ``params`` along ``grads`` from ``state`` (see
    :func:`adam_init`), in ``optax.adam``'s arithmetic: the moments
    ``(1 - b) * g^k + b * m``, the bias corrections ``1 - b**count`` taken
    at float64 from the device count and cast to each moment's dtype, and
    ``p + (-lr) * mu_hat / (sqrt(nu_hat) + eps)``. Returns (the new params,
    the new state), tuples; reads nothing back to the host."""
    mu, nu, count = state
    mu = tuple((1 - b1) * g + b1 * m for g, m in zip(grads, mu))
    nu = tuple((1 - b2) * (g * g) + b2 * v for g, v in zip(grads, nu))
    count = count + 1
    steps = count.to(torch.float64)
    bc1, bc2 = 1 - b1 ** steps, 1 - b2 ** steps
    new = tuple(p + (-lr) * ((m / bc1.to(m.dtype)) / (torch.sqrt(v / bc2.to(v.dtype)) + eps))
                for p, m, v in zip(params, mu, nu))
    return new, (mu, nu, count)


@dataclasses.dataclass
class Program:
    """One of diff/'s compiled programs with its arguments: the function of
    ``graphed`` applied once to ``args`` (``length`` None, the counterpart of
    ``jax.jit``), or scanned ``length`` times from the carry ``args[0]`` (of
    ``lax.scan``).

    Calling it replays the function's CUDA graph where the arguments lie on a
    CUDA device (``graphed``, captured by the first call of their structure:
    a host sync in that first run raises, and so does a capture that fails;
    nothing runs op by op in the graph's place), and runs the function
    eagerly elsewhere or with ``graph=False`` (the fits over a gloo group,
    whose collectives copy through the host, which a graph cannot hold).
    :meth:`eager` and :meth:`replay` are the two arms on their own.
    """

    graphed: Graphed
    args: tuple
    length: Optional[int] = None

    def eager(self):
        fn = self.graphed.fn
        if self.length is None:
            return fn(*self.args)
        return scan(fn, *self.args, length=self.length)

    def replay(self):
        if self.length is None:
            return self.graphed(*self.args)
        return self.graphed.scan(*self.args, length=self.length)

    def __call__(self, graph: bool = True):
        leaves = []
        split_tensors(self.args, leaves)
        if graph and leaves[0].device.type == "cuda":
            return self.replay()
        return self.eager()
