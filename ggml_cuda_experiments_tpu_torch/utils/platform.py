"""Which path a wrapper takes: the kernel for a CUDA tensor, the plain
PyTorch version for a CPU tensor.

The port's analog of ``interpret_default`` in the reference's
``utils/platform.py``: there the same Pallas source runs interpreted on the
CPU and compiled on the TPU; here a wrapper runs its plain PyTorch version
for a tensor on the CPU and launches its hand-written kernel for a tensor on
the card. A wrapper never falls back from the kernel to the plain version.

``plain_versions()`` is the one explicit exception, for comparisons on the
card: inside it every wrapper runs its plain version, so a whole model can be
held against its kernel path on the same device and weights.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_state = threading.local()


def kernels_for(t: torch.Tensor) -> bool:
    """True iff ``t`` lies on a CUDA device (and no ``plain_versions()``
    block is active): the wrapper must then launch its kernel."""
    return t.is_cuda and not getattr(_state, "plain", False)


@contextlib.contextmanager
def plain_versions():
    """Run every wrapper's plain PyTorch version, on whatever device its
    inputs lie, for the duration of the block."""
    prev = getattr(_state, "plain", False)
    _state.plain = True
    try:
        yield
    finally:
        _state.plain = prev


def require_cuda() -> torch.device:
    """The first CUDA device; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False")
    return torch.device("cuda", 0)
