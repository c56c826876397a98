"""Device facts for the port: the card's name and power limit as
``nvidia-smi`` reports them, and the published specs of the cards the port
targets (the analog of the reference's ``utils/device_info.py`` table).

A card may run below its maximum power limit, and then slower under load,
so every measurement the port keeps is printed beside ``card_line()``.
"""

from __future__ import annotations

import dataclasses
import subprocess

import torch


@dataclasses.dataclass(frozen=True)
class CardSpec:
    name: str
    sms: int
    hbm_bytes_per_s: float
    l2_bytes: int
    peak_flops_bf16: float          # dense tensor-core rate
    peak_ops_int8: float            # dense tensor-core int8 rate
    peak_flops_f32: float           # f32 outside the tensor cores
    smem_per_block: int             # opt-in dynamic shared memory limit

    def peak(self, kind: str) -> float:
        """Peak operations per second for operations of ``kind``: "bf16"
        (also f16) and "int8" on the tensor cores, "f32" outside them."""
        return {"bf16": self.peak_flops_bf16, "int8": self.peak_ops_int8,
                "f32": self.peak_flops_f32}[kind]

    def bound_ms(self, nbytes: float, ops: float, kind: str
                 ) -> tuple[float, str]:
        """The least time the card could take for work that moves
        ``nbytes`` and does ``ops`` operations of ``kind``, and which of
        the two sets it."""
        t_bytes, t_ops = nbytes / self.hbm_bytes_per_s, ops / self.peak(kind)
        return (1e3 * max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")


# NVIDIA data sheets and the Hopper architecture white paper (dense rates).
# Keyed by a substring of torch.cuda.get_device_name(); the SXM part reports
# itself as "NVIDIA H100 80GB HBM3".
_SPECS = {
    "H100 PCIe": CardSpec("H100 PCIe", 114, 2.0e12, 50 * 2**20, 756e12,
                          1513e12, 51e12, 232_448),
    "H100": CardSpec("H100 SXM", 132, 3.35e12, 50 * 2**20, 989e12,
                     1979e12, 67e12, 232_448),
}


def card_spec(name: str | None = None) -> CardSpec | None:
    """Spec of the named card (default: CUDA device 0), or None if the
    table has no row for it."""
    if name is None:
        name = torch.cuda.get_device_name(0)
    for key, spec in _SPECS.items():
        if key in name:
            return spec
    return None


def card_line() -> str:
    """``name, power.limit`` of every card, one line each, exactly as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them. Raises when nvidia-smi fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
