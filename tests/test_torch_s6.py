"""The port's q4_k "s6" encoding against the JAX package's (on the CPU;
JAX's Pallas kernels run interpreted, the port's wrappers take their plain
versions).

The container: its fields are the oracle's 6-bit sc / mn and its d / dmin
rounded to bf16, in logical order (JAX keeps sc / mn in its lane order, d
in logical order); dequantization and ``scales_to_e`` are bit-equal to
JAX's (``dequantize_jnp``, ``scales_to_e``); K % 4096 != 0 keeps "e" in
both. ``qmatmul`` on the JAX test's five routes
(tests/test_quant_matmul.py::test_s6_encoding_all_paths) at its
tolerances: 1e-4 * max for the exact f32 ones (chunk, xla), 2e-2 * max for
the int8 / bf16 ones (chunk8, mxu_b16, pipelined). The fused MLP and the
fused attention block on s6 weights at the fused kernels' 5e-3 * max
(k_new / v_new 2e-2 * max(1, max)), as tests/test_torch_fused_*.py hold
them. A GCTC file holds an s6 tree (``q4_k~s6+logical`` names) and reads
it back."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu.oracle import quant as quant_ref
from ggml_cuda_experiments_tpu.ops import fused_attention as jfa
from ggml_cuda_experiments_tpu.ops import quant_matmul as jqm
from ggml_cuda_experiments_tpu_torch.ops import fused_attention as tfa
from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as tqm
from ggml_cuda_experiments_tpu_torch.utils import loader


def _w(seed, n, k, scale=None):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, k)) * (scale or k ** -0.5)).astype(np.float32)


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(np.asarray(got, np.float32) - want).max() / np.abs(
        want).max()


@pytest.fixture(scope="module", params=[4096, 12288])
def s6(request):
    """(K, oracle blocks, the JAX s6 weight, the port's) of one [256, K]."""
    k = request.param
    t = quant_ref.quantize_q4_k(_w(k, 256, k))
    return k, t, jqm.from_oracle(t, enc="s6"), tqm.from_oracle(
        t, device="cpu", enc="s6")


def test_fields_are_the_oracles_in_logical_order(s6):
    k, t, jq, tq = s6
    kb = k // 32
    assert tq.enc == "s6" and tq.s6 and tq.em is None and tq.qh is None
    assert tq.es.dtype == torch.int8 and tq.es.shape == (256, 2 * kb)
    assert tq.d.dtype == torch.bfloat16 and tq.d.shape == (256, 2 * k // 256)
    assert np.array_equal(tq.qs.numpy(), t.qs)
    assert np.array_equal(tq.es[:, :kb].numpy(), t.sc.astype(np.int8))
    assert np.array_equal(tq.es[:, kb:].numpy(), t.mn.astype(np.int8))
    dd = np.concatenate([t.d, t.dmin], axis=1)
    assert np.array_equal(tq.d.float().numpy(),
                          torch.from_numpy(dd).to(torch.bfloat16).float()
                          .numpy())
    # JAX: the same d | dmin, sc | mn in its lane order
    assert np.array_equal(tq.d.float().numpy(),
                          np.asarray(jq.d, np.float32))
    p32 = np.asarray(jqm._layout_perms(k, "std")[1])
    assert np.array_equal(np.asarray(jq.es)[:, :kb], t.sc[:, p32])
    assert tq.nbytes == jq.nbytes == 256 * k * 0.578125
    got = tqm.quantize(torch.from_numpy(_w(k, 256, k)), enc="s6")
    for f in ("qs", "es", "d"):
        assert torch.equal(getattr(got, f), getattr(tq, f)), f


@pytest.mark.parametrize("layout", ["std", "wof"])
def test_dequantize_and_scales_to_e_bit_equal_to_jax(layout):
    k = 4096
    t = quant_ref.quantize_q4_k(_w(1, 64, k))
    jq = jqm.from_oracle(t, layout=layout, enc="s6")
    tq = tqm.from_oracle(t, device="cpu", enc="s6")
    assert np.array_equal(tqm.dequantize(tq).numpy(),
                          np.asarray(jqm.dequantize_jnp(jq)))
    je, te = jqm.scales_to_e(jq), tqm.scales_to_e(tq)
    assert te.enc == "e" and te.es.dtype == torch.float32
    p32 = np.asarray(jqm._layout_perms(k, layout)[1])
    assert np.array_equal(te.es.numpy()[:, p32], np.asarray(je.es))
    assert np.array_equal(te.em.numpy()[:, p32], np.asarray(je.em))
    # an "e" weight goes through unchanged
    e = tqm.from_oracle(t, device="cpu")
    assert tqm.scales_to_e(e) is e


@pytest.mark.parametrize("k", [512, 2048, 5632])
def test_k_off_4096_keeps_e(k):
    t = quant_ref.quantize_q4_k(_w(2, 32, k))
    jq = jqm.from_oracle(t, enc="s6")
    tq = tqm.from_oracle(t, device="cpu", enc="s6")
    assert jq.enc == tq.enc == "e"
    assert torch.equal(tq.es, tqm.from_oracle(t, device="cpu").es)
    with pytest.raises(ValueError):
        tqm.from_oracle(t, device="cpu", enc="s4")


@pytest.mark.parametrize("path", ["chunk", "chunk8", "mxu_b16", "pipelined",
                                  "xla"])
def test_qmatmul_routes_match_jax(s6, path):
    k, _, jq, tq = s6
    b = 16 if path == "mxu_b16" else 1
    x = np.random.default_rng(3).normal(size=(b, k)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if path == "chunk":
        want, got, tol = (jqm.qmatmul(xj, jq, use_vpu=True),
                          tqm.qmatmul(xt, tq), 1e-4)
    elif path == "chunk8":
        want, got, tol = (jqm.qmatmul(xj, jq, use_vpu=True, x_quant8=True),
                          tqm.qmatmul(xt, tq, x_quant8=True), 2e-2)
    elif path == "mxu_b16":
        want, got, tol = (jqm.qmatmul(xj, jq, block_n=128),
                          tqm.qmatmul(xt, tq), 2e-2)
    elif path == "pipelined":         # the port's one GEMM kernel
        want, got, tol = (jqm.qmatmul(xj, jq, block_n=128, pipelined=True),
                          tqm.q4k_s6_gemm(xt.to(torch.bfloat16), tq), 2e-2)
    else:
        want, got, tol = (jqm.qmatmul_xla(xj, jq, compute_dtype=jnp.float32),
                          tqm.qmatmul_ref(xt, tq), 1e-4)
    assert got.shape == (b, 256)
    assert _rel(got.numpy(), want) < tol


def test_dispatch_reaches_the_s6_wrappers(monkeypatch):
    """qmatmul sends an s6 weight to the s6 wrappers (one row: the exact or
    the int8 matvec; more: the GEMM), never to a Q4_K-E one; the e
    wrappers and kernels refuse an s6 weight on the card (checked before a
    launch, so here by the check itself)."""
    tq = tqm.quantize(torch.from_numpy(_w(4, 64, 4096)), enc="s6")
    seen = []
    for name in ("q4k_s6_matvec", "q4k_s6_q8_matvec", "q4k_s6_gemm",
                 "q4k_matvec", "q4k_q8_matvec", "q4k_gemm"):
        fn = getattr(tqm, name)
        monkeypatch.setattr(tqm, name, lambda x, w, _n=name, _f=fn: (
            seen.append(_n), _f(x, w))[1])
    x = torch.ones((3, 4096))
    tqm.qmatmul(x[:1], tq)
    tqm.qmatmul(x[:1], tq, x_quant8=True)
    tqm.qmatmul(x, tq)
    assert seen == ["q4k_s6_matvec", "q4k_s6_q8_matvec", "q4k_s6_gemm"]
    with pytest.raises(ValueError, match="s6"):
        tqm._check_ql(tq, torch.device("cpu"))
    tqm._check_ql(tq, torch.device("cpu"), enc="s6")
    assert tqm.LAUNCHES["q4k_s6_matvec"] == 0


def test_mlp_fused_matches_jax():
    kg, kd, nd = 4096, 4096, 256
    wg, wu, wd = (_w(5, kd, kg, 1 / 64), _w(6, kd, kg, 1 / 64),
                  _w(7, nd, kd, 1 / 64))
    jgu = jqm.from_oracle(quant_ref.quantize_q4_k(jqm.reorder_gu_rows(wg, wu)),
                          enc="s6")
    jd = jqm.from_oracle(quant_ref.quantize_q4_k(wd), enc="s6")
    tgu = tqm.quantize(torch.from_numpy(np.concatenate([wg, wu])), enc="s6")
    td = tqm.quantize(torch.from_numpy(wd), enc="s6")
    assert jqm.mlp_fused_supported(jgu, jd)
    assert tqm.mlp_fused_supported(tgu, td)
    x = np.random.default_rng(8).normal(size=(1, kg)).astype(np.float32)
    want = jqm.mlp_fused(jqm.permute_activations(jnp.asarray(x)), jgu, jd)
    got = tqm.mlp_fused(torch.from_numpy(x), tgu, td)
    assert got.shape == (1, nd) and _rel(got.numpy(), want) < 5e-3


def test_attention_fused_matches_jax():
    length = 255                      # the new token in the last slot
    hkv, dim, d, s = 8, 4096, 128, 256
    rng = np.random.default_rng(9)
    wqkv = (rng.normal(size=((32 + 2 * hkv) * d, dim)) / 64).astype(
        np.float32)
    wo = (rng.normal(size=(dim, dim)) / 64).astype(np.float32)
    kc = rng.normal(size=(2, 1, hkv, s, d)).astype(np.float32)
    vc = rng.normal(size=(2, 1, hkv, s, d)).astype(np.float32)
    x = rng.normal(size=(1, dim)).astype(np.float32)
    j = (jqm.from_oracle(quant_ref.quantize_q4_k(wqkv), enc="s6"),
         jqm.from_oracle(quant_ref.quantize_q4_k(wo), layout="wof",
                         enc="s6"),
         jnp.asarray(kc, jnp.bfloat16), jnp.asarray(vc, jnp.bfloat16))
    t = (tqm.quantize(torch.from_numpy(wqkv), enc="s6"),
         tqm.quantize(torch.from_numpy(wo), enc="s6"),
         torch.from_numpy(kc).to(torch.bfloat16),
         torch.from_numpy(vc).to(torch.bfloat16))
    kw = dict(n_heads=32, n_kv_heads=hkv, head_dim=d)
    assert jfa.attention_fused_supported(j[0], j[1], 32, hkv, d,
                                         jnp.bfloat16)
    assert tfa.attention_fused_supported(t[0], t[1], 32, hkv, d,
                                         torch.bfloat16)
    lens = np.asarray([length], np.int32)
    want = jfa.attention_fused(jnp.asarray(x), *j, jnp.asarray(lens), 1, **kw)
    got = tfa.attention_fused(torch.from_numpy(x), *t, torch.from_numpy(lens),
                              1, **kw)
    assert got[0].shape == (1, dim) and _rel(got[0].numpy(), want[0]) < 5e-3
    for g, w in zip(got[1:], want[1:]):
        w = np.asarray(w, np.float32)
        assert np.abs(g.float().numpy() - w).max() <= 2e-2 * max(
            1.0, np.abs(w).max())


def test_gctc_round_trip(tmp_path):
    """An s6 weight beside an "e" one and a dense leaf: the s6 entries are
    named ``q4_k~s6+logical`` and read back bit-equal, with their enc."""
    w = torch.from_numpy(_w(10, 64, 4096))
    tree = {"a": tqm.quantize(w, enc="s6"), "b": tqm.quantize(w),
            "norm": torch.ones(4096, dtype=torch.bfloat16)}
    path = tmp_path / "s6.gctc"
    loader.save_params(path, tree)
    names = list(loader.load_container(path))
    assert "a#q4_k~s6+logical#64x4096#es" in names
    assert "b#q4_k+logical#64x4096#es" in names
    got = loader.load_params(path, device="cpu")
    assert got["a"].enc == "s6" and got["b"].enc == "e"
    for key, fields in (("a", ("qs", "es", "d")), ("b", ("qs", "es", "em"))):
        for f in fields:
            assert torch.equal(getattr(got[key], f), getattr(tree[key], f))
        assert got[key].em is None or key == "b"
    assert torch.equal(tqm.dequantize(got["a"]), tqm.dequantize(tree["a"]))


def _s6_tree(quantize_params, module, quantize, params, **kw):
    """``quantize_params`` of ``params`` with ``module.quantize`` swapped for
    ``quantize`` called with ``enc="s6"``: the package's own tree layout
    and MLP pad, every q4_k linear in s6 (neither package's quantize_params
    takes an ``enc``)."""
    saved = module.quantize
    module.quantize = lambda *a, **k: quantize(*a, **k, enc="s6")
    try:
        return quantize_params(params, "q4_k", **kw)
    finally:
        module.quantize = saved


def test_s6_model_matches_jax():
    """A one-layer model at the 7B's width with every linear in s6 (the
    intermediate 3800 padded to 4096, 2 KV heads, vocab 512): prefill and
    a greedy decode step of the port against the JAX package's on the same
    weights, logits within 2e-2 * max, tokens equal."""
    import dataclasses

    import jax
    from ggml_cuda_experiments_tpu.models import llama as jl
    from ggml_cuda_experiments_tpu.models.config import PRESETS
    from ggml_cuda_experiments_tpu_torch.models import convert
    from ggml_cuda_experiments_tpu_torch.models import llama as tl
    from ggml_cuda_experiments_tpu_torch.models.config import ModelConfig
    cfg = dataclasses.replace(PRESETS["llama2-7b"], n_layers=1, n_kv_heads=2,
                              vocab_size=512, intermediate=3800,
                              fuse_mlp=False, fuse_attn=False,
                              fuse_layer=False)
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    jp = jl.init_weights(cfg, seed=31)
    tp = convert.params_from_jax(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp), tcfg,
        device="cpu")
    jq = _s6_tree(jl.quantize_params, jl, jqm.quantize, jp)
    tq = _s6_tree(tl.quantize_params, tl, tqm.quantize, tp)
    lay = tq["layers"][0]
    assert lay["w_down"].shape == (4096, 4096)
    assert {w.enc for w in (lay["wqkv"], lay["wo"], lay["w_gu"],
                            lay["w_down"], tq["lm_head"])} == {"s6"}
    assert jq["layers"][0]["wqkv"].enc == "s6"
    prompt = np.random.default_rng(32).integers(
        0, cfg.vocab_size, size=(1, 8)).astype(np.int32)
    jc = jl.KVCache.create(cfg, 1, 256)
    tc = tl.KVCache.create(tcfg, 1, 256, device="cpu")
    jlog, jc = jl.prefill(jq, cfg, jnp.asarray(prompt), jc)
    tlog, tc = tl.prefill(tq, tcfg, torch.from_numpy(prompt), tc)
    for _ in range(2):
        want = np.asarray(jlog, np.float32)
        assert _rel(tlog.numpy(), want) <= 2e-2
        tok = int(np.argmax(want))
        assert int(tlog.argmax()) == tok
        jlog, jc = jl.decode_step(jq, cfg, jnp.asarray([tok], jnp.int32), jc)
        tlog, tc = tl.decode_step(tq, tcfg, torch.tensor([tok],
                                                          dtype=torch.int32),
                                  tc)
