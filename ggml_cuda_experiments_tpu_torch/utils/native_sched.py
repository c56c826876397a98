"""ctypes binding of the C++ continuous-batching scheduler
(``csrc/native/gct_sched.cpp``), the port's counterpart of the JAX
package's ``utils/native_sched.py``, with the same signatures.

It makes the python scheduler's decisions (``models/engine.py``:
admission, page allocation from a FIFO free list, completion, release),
as ``tests/test_torch_native_sched.py`` holds it; ``Engine(scheduler=
"native")`` takes admission and completion from it. The library is the
port's own, built from its sources at first use (``utils/native.py``).
"""

from __future__ import annotations

import numpy as np

from ggml_cuda_experiments_tpu_torch.utils import native


class NativeScheduler:
    """Owns admission, page allocation, per-slot lengths and completion.
    ``n_pages`` counts the usable pages; the trash page is id ``n_pages``
    (the Engine passes its pool's page count less its trash page, so the
    ids line up with its own)."""

    def __init__(self, max_batch: int, n_pages: int, pages_per_seq: int,
                 page_size: int, max_seq_len: int):
        self._lib = native.lib()
        self._h = self._lib.gct_sched_new(max_batch, n_pages, pages_per_seq,
                                          page_size, max_seq_len)
        self.max_batch = max_batch
        self.pages_per_seq = pages_per_seq

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.gct_sched_free(self._h)
            self._h = None

    def add_request(self, rid: int, prompt_len: int,
                    max_new_tokens: int) -> None:
        self._lib.gct_sched_add_request(self._h, rid, prompt_len,
                                        max_new_tokens)

    def admit(self) -> list[tuple[int, int, np.ndarray]]:
        """Admit waiting requests; returns [(rid, slot, page_row)]."""
        cap = self.max_batch
        rids = np.zeros(cap, np.int32)
        slots = np.zeros(cap, np.int32)
        pages = np.zeros((cap, self.pages_per_seq), np.int32)
        n = self._lib.gct_sched_admit(self._h, rids, slots,
                                      pages.reshape(-1))
        return [(int(rids[i]), int(slots[i]), pages[i].copy())
                for i in range(n)]

    def step_complete(self, hit_eos: np.ndarray) -> list[tuple[int, int]]:
        """Advance every running slot one token; returns the finished
        [(rid, slot)], whose pages are already released."""
        cap = self.max_batch
        frids = np.zeros(cap, np.int32)
        fslots = np.zeros(cap, np.int32)
        n = self._lib.gct_sched_step_complete(
            self._h, np.ascontiguousarray(hit_eos, np.uint8), frids, fslots)
        return [(int(frids[i]), int(fslots[i])) for i in range(n)]

    @property
    def num_running(self) -> int:
        return self._lib.gct_sched_num_running(self._h)

    @property
    def num_waiting(self) -> int:
        return self._lib.gct_sched_num_waiting(self._h)

    @property
    def num_free_pages(self) -> int:
        return self._lib.gct_sched_num_free_pages(self._h)

    def state(self) -> tuple[np.ndarray, np.ndarray]:
        """(lengths [max_batch], page table [max_batch, pages_per_seq])."""
        lengths = np.zeros(self.max_batch, np.int32)
        table = np.zeros(self.max_batch * self.pages_per_seq, np.int32)
        self._lib.gct_sched_state(self._h, lengths, table)
        return lengths, table.reshape(self.max_batch, self.pages_per_seq)
