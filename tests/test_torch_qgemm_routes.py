"""The route rule of the port's dequantizing GEMM (``q4k_gemm``,
``q40_gemm``, ``q80_gemm``: ``csrc/q4k_gemm.cu``): ``gemm_route`` picks
the weight-stream kernel for decode batches and the tensor-core kernel
above, from M alone; ``qmatmul`` reaches the format's GEMM at every route
edge; on the CPU the wrappers run their plain version and count no launch
and no route. The plain version at each edge against the JAX ``qmatmul``
(interpret mode) is ``tests/test_torch_quant_matmul.py::
test_gemm_matches_jax``; the kernels themselves run in
``tests/test_torch_cuda.py`` on the card."""

import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as tqm

GEMMS = {"q4_k": "q4k_gemm", "q4_0": "q40_gemm", "q8_0": "q80_gemm"}
EDGE = tqm.STREAM_MAX_M


@pytest.mark.parametrize("m", [1, 2, 5, 8, EDGE])
def test_decode_batches_stream(m):
    assert tqm.gemm_route(m) == "stream"


@pytest.mark.parametrize("m", [EDGE + 1, 64, 128, 512, 4096])
def test_larger_batches_take_the_tensor_cores(m):
    assert tqm.gemm_route(m) == "tc"


def test_the_rule_is_one_threshold():
    routes = [tqm.gemm_route(m) for m in range(1, 513)]
    assert routes == ["stream"] * EDGE + ["tc"] * (512 - EDGE)


@pytest.mark.parametrize("m", [0, -3])
def test_no_rows_raises(m):
    with pytest.raises(ValueError):
        tqm.gemm_route(m)


@pytest.mark.parametrize("fmt", sorted(GEMMS))
@pytest.mark.parametrize("m", [2, EDGE, EDGE + 1, 70])
def test_cpu_gemm_is_the_plain_version_at_the_edges(fmt, m):
    k = 768 if fmt == "q4_k" else 544          # a whole q4_k superblock
    rng = np.random.default_rng(m)
    w = tqm.quantize(torch.from_numpy(
        (rng.normal(size=(48, k)) / np.sqrt(k)).astype(np.float32)), fmt)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    before = dict(tqm.LAUNCHES), dict(tqm.GEMM_ROUTE_LAUNCHES)
    got = getattr(tqm, GEMMS[fmt])(xb, w)
    assert torch.equal(got, tqm.qmatmul_ref(xb, w, torch.bfloat16))
    assert torch.equal(tqm.qmatmul(x, w),
                       tqm.qmatmul_ref(x, w, torch.bfloat16))
    assert (dict(tqm.LAUNCHES), dict(tqm.GEMM_ROUTE_LAUNCHES)) == before

