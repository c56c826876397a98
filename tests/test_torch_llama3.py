"""One llama3-8b-width layer: the port's model against the JAX package's
(both on the CPU; JAX's Pallas kernels run interpreted, the port's
wrappers take their plain versions), with tests/test_torch_llama.py's
weights, quantization and greedy loop. A file of its own so that it runs
beside that file's 7B-width cases, not after them."""

import dataclasses

import numpy as np

from ggml_cuda_experiments_tpu.models.config import PRESETS
from ggml_cuda_experiments_tpu.ops import quant_matmul as jqm
from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as tqm
from test_torch_llama import _assert_close, _both, _greedy_pair

# one layer at llama3-8b's width in the preset's configuration: GQA 32/8,
# rope_theta 5e5, the 14336 -> 16384 intermediate pad and the fused MLP at
# Kd 16384 (its int8 mid), the vocabulary cut from 128256
ONE_LAYER_L3 = dataclasses.replace(PRESETS["llama3-8b"], n_layers=1,
                                   vocab_size=512)


def test_llama3_width_one_layer_matches_jax():
    """The preset's decode runs the fused MLP, whose mid is quantized to
    int8 per 32-block (tests/test_torch_fused_matvec.py holds the fused
    MLP alone against the JAX kernel on one input). Here the ulps in which
    the two packages' attention and norms differ move whole int8 steps of
    the mid, so the logits are held at 3e-2 * max, the JAX package's bound
    for int8-activation decode logits
    (tests/test_quant_matmul.py::test_model_x_quant8_decode). Greedy
    tokens exact (top-2 gap >= 0.1, asserted)."""
    jq, tq = _both(ONE_LAYER_L3, 11)
    jlay, tlay = jq["layers"][0], tq["layers"][0]
    assert tlay["w_down"].array_shape == (4096, 16384)
    assert tlay["wqkv"].array_shape == (6144, 4096)
    assert tqm.mlp_fused_supported(tlay["w_gu"], tlay["w_down"])
    assert np.array_equal(tqm.dequantize(tlay["w_down"]).numpy(),
                          np.asarray(jqm.dequantize_jnp(jlay["w_down"])))
    prompt = np.random.default_rng(4).integers(
        0, ONE_LAYER_L3.vocab_size, size=(1, 8)).astype(np.int32)
    jlog, tlog, jtok, ttok = _greedy_pair(jq, tq, ONE_LAYER_L3, prompt,
                                          steps=2)
    top2 = np.sort(jlog, -1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() >= 0.1
    assert np.array_equal(ttok, jtok)
    _assert_close(tlog, jlog, tol=3e-2)
