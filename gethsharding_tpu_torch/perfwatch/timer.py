"""`ensure_host`: the serving tier's dispatch-latency clock must close over
finished work (the port's form of the JAX package's
`perfwatch/timer.py::ensure_host`).

Kernel launches return before the card finishes, so a backend that hands
back a CUDA tensor (or a list whose elements are CUDA tensors) would let
the clock stop at the enqueue. `ensure_host` pulls such a value to the
host once: a tensor becomes a host list, and a list whose first element
is a CUDA tensor is forced through that element (all outputs of one
dispatch finish together). Host lists pass through untouched.
"""

from __future__ import annotations

import torch

from gethsharding_tpu_torch import metrics

_M_PULLS = metrics.counter("perfwatch/pulls")


def ensure_host(value, op: str = "dispatch"):
    """`value` with every CUDA tensor in it finished (see the module
    docstring); `op` names the call in nothing but the pull counter."""
    if isinstance(value, (list, tuple)):
        if value and isinstance(value[0], torch.Tensor) and value[0].is_cuda:
            value[0].cpu()
            _M_PULLS.inc()
        return value
    if isinstance(value, torch.Tensor):
        _M_PULLS.inc()
        return value.cpu().tolist()
    return value
