"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at small and ragged shapes (the full-size checks are in
chip_smoke.py). Marked ``cuda``: they skip where no CUDA device is
present. This file imports no jax, so it also runs on a machine without
it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: the exact-f32 matvec 1e-4 * max, the bf16
GEMM 2e-2 * max, attention 1e-2 * max, model logits 2e-2 * max."""

import dataclasses

import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu_torch.models import llama
from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
from ggml_cuda_experiments_tpu_torch.ops import flash_attention as fa
from ggml_cuda_experiments_tpu_torch.ops import flash_decode as fd
from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
from ggml_cuda_experiments_tpu_torch.utils.platform import plain_versions

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (rng.normal(size=shape) * scale).astype(np.float32))


def _check(fn, *args, tol, **kw):
    got = fn(*args, **kw)
    with plain_versions():
        ref = fn(*args, **kw)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and torch.isfinite(got).all()
    err = (got.float() - ref.float()).abs().max()
    assert err <= tol * ref.float().abs().max(), float(err)


@pytest.mark.parametrize("n,k", [(300, 256), (4096, 4096), (37, 12288)])
def test_q4k_matvec(dev, n, k):
    ql = qm.quantize(_randn(0, n, k, scale=k ** -0.5).to(dev))
    before = qm.LAUNCHES["q4k_matvec"]
    _check(qm.q4k_matvec, _randn(1, 1, k).to(dev), ql, tol=1e-4)
    assert qm.LAUNCHES["q4k_matvec"] == before + 1


@pytest.mark.parametrize("m", [2, 17, 70])
def test_q4k_gemm(dev, m):
    ql = qm.quantize(_randn(2, 130, 512, scale=512 ** -0.5).to(dev))
    x = _randn(3, m, 512).to(dev, torch.bfloat16)
    _check(qm.q4k_gemm, x, ql, tol=2e-2)


@pytest.mark.parametrize("hq,hkv,d", [(8, 8, 128), (4, 2, 64), (32, 2, 128)])
@pytest.mark.parametrize("splits", [None, 1, 5])
def test_flash_decode(dev, hq, hkv, d, splits):
    L, B, S = 3, 3, 320
    q = _randn(4, B, hq, d).to(dev, torch.bfloat16)
    k = _randn(5, L, B, hkv, S, d).to(dev, torch.bfloat16)
    v = _randn(6, L, B, hkv, S, d).to(dev, torch.bfloat16)
    lengths = torch.tensor([0, 37, 320], dtype=torch.int32, device=dev)
    _check(fd.flash_decode, q, k, v, lengths, layer=2, kv_splits=splits,
           tol=1e-2)


@pytest.mark.parametrize("hq,hkv,d", [(4, 2, 64), (2, 2, 128)])
@pytest.mark.parametrize("sq,sk", [(8, 8), (100, 100), (128, 128),
                                   (40, 200)])
def test_flash_attention(dev, hq, hkv, d, sq, sk):
    q = _randn(7, 2, hq, sq, d).to(dev, torch.bfloat16)
    k = _randn(8, 2, hkv, sk, d).to(dev, torch.bfloat16)
    v = _randn(9, 2, hkv, sk, d).to(dev, torch.bfloat16)
    _check(fa.flash_attention, q, k, v, causal=True, tol=1e-2)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    ql = qm.quantize(_randn(0, 64, 256).to(dev))
    with pytest.raises(ValueError):
        qm.q4k_matvec(torch.zeros((1, 256), dtype=torch.float16,
                                  device=dev), ql)
    with pytest.raises(ValueError):
        qm.q4k_gemm(torch.zeros((4, 256), device=dev), ql)   # f32, not bf16
    q = torch.zeros((1, 4, 96), dtype=torch.bfloat16, device=dev)
    kv = torch.zeros((1, 2, 64, 96), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        fd.flash_decode(q, kv, kv)                             # D = 96
    with pytest.raises(ValueError):
        fa.flash_attention(q[:, :, None], kv, kv)              # D = 96


def test_debug_model_on_the_card_matches_the_cpu(dev):
    cfg = dataclasses.replace(PRESETS["debug"], n_layers=2)
    params = llama.quantize_params(llama.init_weights(cfg, seed=0), "q4_k")
    moved = _to(params, dev)
    prompt = torch.arange(1, 9)[None]
    outs = []
    for p, device in ((params, "cpu"), (moved, dev)):
        cache = llama.KVCache.create(cfg, 1, 256, device=device)
        logits, cache = llama.prefill(p, cfg, prompt.to(device), cache)
        seq = [logits.cpu()]
        for t in (3, 5, 7):
            logits, cache = llama.decode_step(
                p, cfg, torch.tensor([t], device=device), cache)
            seq.append(logits.cpu())
        outs.append(torch.cat(seq))
    err = (outs[1] - outs[0]).abs().max()
    assert err <= 2e-2 * outs[0].abs().max()


def _to(params, dev):
    def mv(w):
        if isinstance(w, qm.QuantLinear):
            return dataclasses.replace(w, qs=w.qs.to(dev), es=w.es.to(dev),
                                       em=w.em.to(dev))
        return w.to(dev)
    out = {k: mv(v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: mv(v) for k, v in layer.items()}
                     for layer in params["layers"]]
    return out
