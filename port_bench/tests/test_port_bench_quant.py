"""The frozen quantizer copy holds bit-equal to the port's quantizer."""

import torch

from port_bench.lib import quant_ref
from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm


def test_frozen_copy_matches_the_port():
    g = torch.Generator().manual_seed(5)
    for fmt, (n, k) in (("q4_k", (96, 512)), ("q6_k", (80, 768))):
        w = (torch.randn((n, k), generator=g) * 0.05).to(torch.bfloat16)
        w[3, :256] = 0                       # an all-zero superblock
        w[5, :32] = w[5, :32].abs()          # a block with no negative
        port = qm.dequantize(qm.quantize(w.float(), fmt, enc="e"))
        mine = quant_ref.dequant(w, fmt)
        assert torch.equal(port, mine), fmt
