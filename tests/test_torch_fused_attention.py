"""The port's fused decode attention block (plain version, on the CPU)
against the JAX package's ``attention_fused`` (Pallas
``_fused_attn_kernel``, interpret mode), MHA 32/32 and GQA 32/8 over a
[2, 1, Hkv, 256, 128] bf16 cache at lengths 1, 23 and 255 (the new token
at the cache's last slot) and 256 (the token past the cache attends over
the cache alone), and its gate against the JAX gate.

The JAX W_o is quantized from the same dense weight in its "wof" column
order, the port's in logical order: the same Q4_K blocks. Tolerances as
tests/test_layer_kernel.py holds the JAX kernels: o 5e-3 * max, k_new /
v_new 2e-2 * max(1, max)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu.ops import fused_attention as jfa
from ggml_cuda_experiments_tpu.ops import quant_matmul as jqm
from ggml_cuda_experiments_tpu_torch.ops import fused_attention as tfa
from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as tqm

DIM, D, S = 4096, 128, 256


@pytest.fixture(scope="module", params=[32, 8], ids=["mha", "gqa8"])
def setup(request):
    hkv = request.param
    rng = np.random.default_rng(11 + hkv)
    wqkv = (rng.normal(size=((32 + 2 * hkv) * D, DIM)) / 64).astype(np.float32)
    wo = (rng.normal(size=(DIM, DIM)) / 64).astype(np.float32)
    kc = rng.normal(size=(2, 1, hkv, S, D)).astype(np.float32)
    vc = rng.normal(size=(2, 1, hkv, S, D)).astype(np.float32)
    x = rng.normal(size=(1, DIM)).astype(np.float32)
    j = (jqm.quantize(wqkv, "q4_k"), jqm.quantize(wo, "q4_k", layout="wof"),
         jnp.asarray(kc, jnp.bfloat16), jnp.asarray(vc, jnp.bfloat16))
    t = (tqm.quantize(torch.from_numpy(wqkv)),
         tqm.quantize(torch.from_numpy(wo)),
         torch.from_numpy(kc).to(torch.bfloat16),
         torch.from_numpy(vc).to(torch.bfloat16))
    return hkv, x, j, t


@pytest.mark.parametrize("length", [1, 23, 255, 256])
def test_attention_fused_matches_jax(setup, length):
    hkv, x, j, t = setup
    kw = dict(n_heads=32, n_kv_heads=hkv, head_dim=D)
    lens = np.asarray([length], np.int32)
    want = jfa.attention_fused(jnp.asarray(x), *j, jnp.asarray(lens), 1, **kw)
    got = tfa.attention_fused(torch.from_numpy(x), *t, torch.from_numpy(lens),
                              1, **kw)
    assert tfa.attention_fused_supported(t[0], t[1], 32, hkv, D,
                                         torch.bfloat16)
    o, ow = got[0].numpy(), np.asarray(want[0], np.float32)
    assert o.shape == (1, DIM) and np.isfinite(o).all()
    assert np.abs(o - ow).max() <= 5e-3 * np.abs(ow).max()
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.bfloat16 and g.shape == (hkv, D)
        w = np.asarray(w, np.float32)
        assert np.abs(g.float().numpy() - w).max() <= 2e-2 * max(
            1.0, np.abs(w).max())


@pytest.mark.parametrize("hq,hkv,d,dim_o", [
    (32, 32, 128, 4096), (32, 8, 128, 4096), (32, 4, 128, 4096),
    (32, 2, 128, 4096), (16, 16, 128, 2048), (32, 4, 64, 2048),
    (64, 8, 128, 8192), (32, 0, 128, 4096)])
def test_wof_gate_matches_jax(hq, hkv, d, dim_o):
    assert (tfa.wof_shape_supported(dim_o, dim_o, hq, hkv, d)
            == jfa.wof_shape_supported(dim_o, dim_o, hq, hkv, d))


def test_plain_attention_is_softmax_over_the_spliced_cache():
    """decode_attention_ref: the new token's k / v stand at length - 1, the
    keys past it are masked, GQA heads share their KV head."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 6, 8)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 6, 8)).astype(np.float32))
    kn, vn = k[:, 0] * 2, v[:, 0] * 3
    o = tfa.decode_attention_ref(q, kn, vn, k, v, torch.tensor([4]))
    for h in range(4):
        g = h // 2
        keys = torch.cat([k[g, :3], kn[g:g + 1]])
        vals = torch.cat([v[g, :3], vn[g:g + 1]])
        want = torch.softmax(keys @ q[h], 0) @ vals
        assert torch.allclose(o[h], want, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hkv", [32, 8, 4])
def test_split_plan_puts_every_key_in_one_split(hkv, dtype):
    """The kernel's split of the keys (``split_plan``) over every length
    before the token, 0 .. S (the last: a token past the cache), on the
    H100's 132 CTAs: the splits run back to back over exactly the
    min(length + 1, S) keys, none empty, each whole tiles but the last, at
    most ctas // Hkv of them, and one split where the keys fill at most
    ONE_SPLIT_TILES tiles."""
    S, tk = 1024, 32 if dtype == torch.bfloat16 else 16
    for length in range(S + 1):
        plan = tfa.split_plan(length, S, hkv, 132, dtype)
        keys = min(length + 1, S)
        assert plan[0][0] == 0 and plan[-1][1] == keys, (length, plan)
        for (a, b), (c, _) in zip(plan, plan[1:]):
            assert b == c and b % tk == 0, (length, plan)
        assert all(b > a for a, b in plan), (length, plan)
        assert len(plan) <= max(1, 132 // hkv)
        if keys <= tk * tfa.ONE_SPLIT_TILES:
            assert len(plan) == 1
        else:
            assert len(plan) == min(132 // hkv, -(-keys // tk))
