"""The port's GGUF reader and writer (``utils/gguf.py``) against the JAX
package's ``utils/gguf.py``, on the CPU.

- Codecs: the port's ``encode_tensor`` gives the JAX bytes for the same
  blocks (NumPy and tensor fields alike), and JAX bytes decode to blocks
  whose dequantization is bit-equal to the JAX one; BF16 bytes decode as
  JAX's; the Q4_K scale pack round-trips; the hand-built Q6_K superblock
  of tests/test_gguf.py decodes to its values.
- Files: the JAX writer's files read in the port and the port's in JAX,
  with every metadata type either writer emits, and the two writers give
  the same bytes.
- Models: files written by the JAX ``write_gguf`` in q8_0, q4_0, q4_k and
  the Q4_K_M mix, with attn_q / attn_k rows in llama.cpp's order, load in
  the port; its ``generate`` is token-exact against JAX ``generate`` on the
  same weights in the JAX order (JAX's Pallas kernels interpreted), logits
  within 2e-2 * max, the bound of tests/test_torch_llama.py.
- The reference's two faults (ROADMAP C.3.3, C.3.4) pinned: JAX's loader
  keeps llama.cpp's Q / K order, and a quantized ``token_embd`` makes JAX's
  decoding raise; the port's model from the same files matches the
  reference on the original weights.
"""

import dataclasses
import io
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu.models import llama as jl
from ggml_cuda_experiments_tpu.models.config import PRESETS
from ggml_cuda_experiments_tpu.oracle import quant as jq
from ggml_cuda_experiments_tpu.ops import quant_matmul as jqm
from ggml_cuda_experiments_tpu.ops.quant_matmul import (
    from_oracle as jax_from_oracle)
from ggml_cuda_experiments_tpu.utils import gguf as jg
from ggml_cuda_experiments_tpu_torch.models import llama as tl
from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as tqm
from ggml_cuda_experiments_tpu_torch.oracle import quant as tq
from ggml_cuda_experiments_tpu_torch.utils import gguf as tg

QUANT = {"q8_0": (jq.quantize_q8_0, jq.dequantize_q8_0, tq.dequantize_q8_0),
         "q4_0": (jq.quantize_q4_0, jq.dequantize_q4_0, tq.dequantize_q4_0),
         "q4_k": (jq.quantize_q4_k, jq.dequantize_q4_k, tq.dequantize_q4_k),
         "q6_k": (jq.quantize_q6_k, jq.dequantize_q6_k, tq.dequantize_q6_k)}
CFG = dataclasses.replace(PRESETS["debug"], dim=256, intermediate=512,
                          vocab_size=512)


def _fields(b):
    return {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}


def _port(b):
    """JAX oracle blocks as the port's (the same fields)."""
    return getattr(tq, type(b).__name__)(**_fields(b))


def _tensors(b):
    """Blocks with tensor fields (what the port's codecs take on a card)."""
    return dataclasses.replace(b, **{
        k: torch.from_numpy(np.ascontiguousarray(v))
        for k, v in _fields(b).items() if k != "shape"})


@pytest.mark.parametrize("fmt", [*QUANT, "f32", "f16"])
def test_codecs_match_jax(rng, fmt):
    w = rng.normal(size=(8, 512)).astype(np.float32)
    if fmt in QUANT:
        quantize, jdeq, tdeq = QUANT[fmt]
        jb = quantize(w)
        pb = _port(jb)
    else:
        jb = pb = w.astype(np.float16 if fmt == "f16" else np.float32)
    jraw, jgt = jg.encode_tensor(jb)
    praw, pgt = tg.encode_tensor(pb)
    assert pgt == jgt and praw.dtype == np.uint8
    assert np.array_equal(praw, jraw)
    traw, _ = tg.encode_tensor(_tensors(pb) if fmt in QUANT
                               else torch.from_numpy(pb))
    assert torch.equal(traw, torch.from_numpy(jraw))

    got = tg.decode_tensor(jraw, jgt, w.shape)
    want = jg.decode_tensor(jraw, jgt, w.shape)
    on_tensor = tg.decode_tensor(torch.from_numpy(jraw), jgt, w.shape)
    if fmt not in QUANT:
        assert np.array_equal(got, want) and got.dtype == np.float32
        assert np.array_equal(on_tensor.numpy(), want)
        return
    assert type(got) is type(pb)
    assert np.array_equal(tdeq(got), jdeq(want))
    for name, v in _fields(want).items():
        if name != "shape":
            assert np.array_equal(getattr(got, name), v), name
            assert getattr(got, name).dtype == v.dtype, name
            assert np.array_equal(getattr(on_tensor, name).numpy(), v), name


def test_bf16_decodes_as_jax(rng):
    bits = rng.integers(0, 2 ** 16, size=(4, 64), dtype=np.uint16)
    bits[(bits & 0x7F80) == 0x7F80] = 0x3F80      # no inf / nan patterns
    raw = bits.view(np.uint8).reshape(-1)
    got = tg.decode_tensor(raw, tg.GGML_BF16, (4, 64))
    assert np.array_equal(got, jg.decode_tensor(raw, jg.GGML_BF16, (4, 64)))


def test_q4k_scale_pack_roundtrip(rng):
    sc = rng.integers(0, 64, (50, 8)).astype(np.uint8)
    mn = rng.integers(0, 64, (50, 8)).astype(np.uint8)
    packed = tg._q4k_scale_pack(torch.from_numpy(sc), torch.from_numpy(mn))
    assert np.array_equal(packed.numpy(), jg._q4k_scale_pack(sc, mn))
    sc2, mn2 = tg._q4k_scale_unpack(packed)
    assert np.array_equal(sc2.numpy(), sc) and np.array_equal(mn2.numpy(), mn)


def test_q6_k_known_superblock():
    """tests/test_gguf.py's superblock: every q = 34, scales 1, d = 0.5."""
    block = np.zeros((1, 210), np.uint8)
    block[0, :128] = 0x22
    block[0, 128:192] = 0xAA
    block[0, 192:208] = 1
    block[0, 208:210] = np.array([0.5], np.float16).view(np.uint8)
    got = tq.dequantize_q6_k(tg.decode_tensor(block.reshape(-1),
                                              tg.GGML_Q6_K, (256,)))
    assert np.array_equal(got, np.full(256, 1.0, np.float32))
    assert np.array_equal(got, jg._dequantize_q6_k(block, (256,)))


def _every_type_file(path, writer, rng):
    w1 = rng.normal(size=(16, 256)).astype(np.float32)
    w2 = rng.normal(size=(64,)).astype(np.float32)
    w3 = rng.normal(size=(4, 32)).astype(np.float16)
    blocks = jq.quantize_q4_k(w1)
    writer.write_gguf(path, {
        "a.weight": blocks if writer is jg else _port(blocks),
        "b.weight": w2, "c.weight": w3,
    }, {"general.architecture": "llama", "llama.block_count": 2,
        "general.name": "test", "pi": 3.5, "flag": True, "big": 2 ** 40,
        "neg": -3, "words": ["x", "y"], "floats": [0.25, -1.5],
        "ints": [1, -2, 3], "empty": []})


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_files_read_across_packages(tmp_path, writer, reader):
    mods = {"jax": jg, "port": tg}
    paths = {}
    for name, mod in mods.items():
        paths[name] = str(tmp_path / f"{name}.gguf")
        _every_type_file(paths[name], mod, np.random.default_rng(5))
    # the two writers give the same bytes
    assert open(paths["jax"], "rb").read() == open(paths["port"], "rb").read()
    got = mods[reader].read_gguf(paths[writer])
    want = mods[writer].read_gguf(paths[writer])
    assert got.metadata == want.metadata
    assert got.metadata["big"] == 2 ** 40 and got.metadata["flag"] is True
    assert got.data_offset == want.data_offset
    assert list(got.tensors) == list(want.tensors)
    for name, info in want.tensors.items():
        assert dataclasses.asdict(got.tensors[name]) == dataclasses.asdict(
            info)
        a, b = got.load(name), want.load(name)
        if isinstance(b, np.ndarray):
            assert np.array_equal(a, b) and a.dtype == b.dtype
        else:
            for f, v in _fields(b).items():
                assert np.array_equal(getattr(a, f), v), (name, f)


def test_every_metadata_value_type_reads_as_jax():
    """The scalar and array types no writer emits (u8 .. f64, nested
    arrays), read from one hand-packed stream by both readers."""
    buf = b"".join(struct.pack("<I", vt) + struct.pack(fmt, v)
                   for vt, fmt, v in [(0, "<B", 200), (1, "<b", -100),
                                      (2, "<H", 60000), (3, "<h", -30000),
                                      (4, "<I", 4 * 10 ** 9), (5, "<i", -2 * 10 ** 9),
                                      (6, "<f", 0.5), (7, "<?", False),
                                      (10, "<Q", 2 ** 63), (11, "<q", -2),
                                      (12, "<d", 0.1)])
    buf += struct.pack("<IIQ", 9, 9, 2)                # array of arrays
    buf += struct.pack("<IQ", 2, 2) + struct.pack("<2H", 7, 8)
    buf += struct.pack("<IQ", 8, 1) + struct.pack("<Q", 2) + b"ab"
    reads = []
    for mod in (tg, jg):
        f = io.BytesIO(buf)
        vals = []
        for _ in range(12):
            (vt,) = struct.unpack("<I", f.read(4))
            vals.append(mod._read_value(f, vt))
        reads.append(vals)
    assert reads[0] == reads[1]
    assert reads[0][-1] == [[7, 8], ["ab"]] and reads[0][-2] == 0.1


@pytest.mark.parametrize("fmt", [None, *QUANT])
def test_qk_permute_both_ways(rng, fmt):
    """permute_qk is the converter's reshape(n_head, 2, hd/2, K)
    .swapaxes(1, 2); unpermute_qk undoes it; on quantized blocks it moves
    whole rows of every field, so permuting commutes with quantizing."""
    n_head, hd, k = 4, 64, 256
    w = rng.normal(size=(n_head * hd, k)).astype(np.float32)
    conv = w.reshape(n_head, 2, hd // 2, k).swapaxes(1, 2).reshape(w.shape)
    if fmt is None:
        assert np.array_equal(tg.permute_qk(w, n_head), conv)
        assert np.array_equal(tg.unpermute_qk(conv, n_head), w)
        t = torch.from_numpy(conv)
        assert torch.equal(tg.unpermute_qk(t, n_head), torch.from_numpy(w))
        return
    b = _port(QUANT[fmt][0](w))
    pb = tg.permute_qk(b, n_head)
    for name, v in _fields(_port(QUANT[fmt][0](conv))).items():
        assert np.array_equal(getattr(pb, name), v), name
    back = tg.unpermute_qk(pb, n_head)
    for name, v in _fields(b).items():
        assert np.array_equal(getattr(back, name), v), name


def test_config_from_metadata_matches_jax():
    md = {"general.architecture": "llama", "general.name": "m",
          "llama.block_count": 3, "llama.embedding_length": 512,
          "llama.attention.head_count": 8,
          "llama.attention.head_count_kv": 2,
          "llama.feed_forward_length": 1024, "llama.context_length": 2048,
          "llama.rope.freq_base": 500000.0,
          "llama.attention.layer_norm_rms_epsilon": 1e-6}
    for extra in ({}, {"llama.vocab_size": 777},
                  {"tokenizer.ggml.tokens": ["a"] * 99},
                  {"llama.attention.key_length": 32}):
        got = tg.config_from_metadata({**md, **extra})
        want = jg.config_from_metadata({**md, **extra})
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_use_more_bits_is_llama_cpp_s():
    """The Q4_K_M rule at 32 layers: the first and last 4, and 6, 9, ..,
    27; at 2 layers the second; at 22 layers 0, 1, 4, 7, 10, 13, 16,
    19-21."""
    pick = lambda n: [i for i in range(n) if tg.use_more_bits(i, n)]
    assert pick(32) == [0, 1, 2, 3, 6, 9, 12, 15, 18, 21, 24, 27, 28, 29,
                        30, 31]
    assert pick(2) == [1]
    assert pick(22) == [0, 1, 4, 7, 10, 13, 16, 19, 20, 21]
    assert tg.q4_k_m_format("output.weight", 2) == "q6_k"
    assert tg.q4_k_m_format("blk.1.attn_v.weight", 2) == "q6_k"
    assert tg.q4_k_m_format("blk.1.attn_q.weight", 2) == "q4_k"
    assert tg.q4_k_m_format("blk.0.ffn_down.weight", 2) == "q4_k"
    assert tg.q4_k_m_format("token_embd.weight", 2) == "q4_k"


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

_METADATA = {
    "general.architecture": "llama", "general.name": "tiny",
    "llama.block_count": CFG.n_layers, "llama.embedding_length": CFG.dim,
    "llama.attention.head_count": CFG.n_heads,
    "llama.attention.head_count_kv": CFG.n_kv_heads,
    "llama.feed_forward_length": CFG.intermediate,
    "llama.attention.key_length": CFG.head_dim,
    "llama.context_length": CFG.max_seq_len,
    "llama.vocab_size": CFG.vocab_size,
    "llama.rope.freq_base": CFG.rope_theta,
    "llama.attention.layer_norm_rms_epsilon": CFG.rms_eps,
}
_LAYER_KEYS = {"attn_q": "wq", "attn_k": "wk", "attn_v": "wv",
               "attn_output": "wo", "ffn_gate": "w_gate", "ffn_up": "w_up",
               "ffn_down": "w_down"}


def _weights(seed):
    """Dense f32 weights under llama.cpp names, in the port's (rotate-half)
    Q / K order."""
    rng = np.random.default_rng(seed)
    norm = lambda *s: (rng.normal(size=s) / np.sqrt(s[-1])).astype(
        np.float32)
    hd, d = CFG.head_dim, CFG.dim
    shapes = {"attn_q": (CFG.n_heads * hd, d), "attn_k": (CFG.n_kv_heads * hd, d),
              "attn_v": (CFG.n_kv_heads * hd, d),
              "attn_output": (d, CFG.n_heads * hd),
              "ffn_gate": (CFG.intermediate, d),
              "ffn_up": (CFG.intermediate, d),
              "ffn_down": (d, CFG.intermediate)}
    w = {"token_embd.weight": norm(CFG.vocab_size, d),
         "output_norm.weight": (1 + 0.1 * rng.normal(size=d)).astype(
             np.float32),
         "output.weight": norm(CFG.vocab_size, d)}
    for i in range(CFG.n_layers):
        for name, shape in shapes.items():
            w[f"blk.{i}.{name}.weight"] = norm(*shape)
        for name in ("attn_norm", "ffn_norm"):
            w[f"blk.{i}.{name}.weight"] = (
                1 + 0.1 * rng.normal(size=d)).astype(np.float32)
    return w


def _blocks(weights, mix):
    """JAX oracle blocks of every 2-D weight (the embedding stays dense
    unless ``mix`` is "q4_k_m", which stores it Q4_K as llama.cpp does)."""
    out = {}
    for name, w in weights.items():
        if w.ndim == 1 or (name == "token_embd.weight" and mix != "q4_k_m"):
            out[name] = w
        else:
            fmt = (tg.q4_k_m_format(name, CFG.n_layers) if mix == "q4_k_m"
                   else mix)
            out[name] = QUANT[fmt][0](w)
    return out


def _llama_cpp_order(blocks):
    """attn_q / attn_k rows permuted as llama.cpp's converter stores
    them."""
    heads = {"attn_q": CFG.n_heads, "attn_k": CFG.n_kv_heads}
    return {name: (tg.permute_qk(b, heads[name.split(".")[2]])
                   if name.split(".")[-2] in heads else b)
            for name, b in blocks.items()}


def _jax_reference(blocks):
    """The JAX params of ``blocks`` in the original (unpermuted) order; a
    quantized embedding replaced by its dequantized bf16."""
    dense = lambda a: jnp.asarray(a, jnp.bfloat16)
    emb = blocks["token_embd.weight"]
    if not isinstance(emb, np.ndarray):
        emb = jqm.dequantize_jnp(jax_from_oracle(emb))
    params = {"embed": dense(emb),
              "final_norm": dense(blocks["output_norm.weight"]),
              "lm_head": jax_from_oracle(blocks["output.weight"]),
              "layers": []}
    for i in range(CFG.n_layers):
        b = lambda n: blocks[f"blk.{i}.{n}.weight"]
        layer = {k: jax_from_oracle(b(n)) for n, k in _LAYER_KEYS.items()}
        layer.update(attn_norm=dense(b("attn_norm")),
                     mlp_norm=dense(b("ffn_norm")))
        params["layers"].append(layer)
    return params


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    """Per mix: (the JAX-written file in llama.cpp's Q / K order, the JAX
    reference params on the original weights, the seed's prompt)."""
    made = {}

    def make(mix):
        if mix not in made:
            seed = {"q8_0": 11, "q4_0": 12, "q4_k": 17, "q4_k_m": 13}[mix]
            blocks = _blocks(_weights(seed), mix)
            path = str(tmp_path_factory.mktemp("gguf") / f"{mix}.gguf")
            jg.write_gguf(path, _llama_cpp_order(blocks), _METADATA)
            prompt = np.random.default_rng(seed).integers(
                0, CFG.vocab_size, size=(1, 8)).astype(np.int32)
            made[mix] = (path, _jax_reference(blocks), prompt)
        return made[mix]

    return make


def _greedy(prefill, decode, argmax, prompt, steps):
    logits, cache = prefill(prompt)
    out = [logits]
    for _ in range(steps):
        logits, cache = decode(argmax(logits), cache)
        out.append(logits)
    return np.stack([np.asarray(x, np.float32) for x in out])


def _jax_cfg(path):
    return jg.config_from_metadata(jg.read_gguf(path).metadata)


def _jax_greedy(params, cfg, prompt, steps):
    return _greedy(
        lambda p: jl.prefill(params, cfg, jnp.asarray(p),
                             jl.KVCache.create(cfg, 1, 256)),
        lambda t, c: jl.decode_step(params, cfg, t, c),
        lambda lg: jnp.argmax(lg, -1).astype(jnp.int32), prompt, steps)


def _port_greedy(params, cfg, prompt, steps):
    return _greedy(
        lambda p: tl.prefill(params, cfg, torch.from_numpy(p).long(),
                             tl.KVCache.create(cfg, 1, 256, device="cpu")),
        lambda t, c: tl.decode_step(params, cfg, t, c),
        lambda lg: torch.argmax(lg, -1).to(torch.int32), prompt, steps)


def _assert_matches(got, want, tol=2e-2):
    assert got.shape == want.shape and np.isfinite(got).all()
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"err {err} vs {tol} * {scale}"
    top2 = np.sort(want, -1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0] >= 0.1).all()     # no near-tie
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("mix", ["q8_0", "q4_0", "q4_k", "q4_k_m"])
def test_loaded_model_matches_jax_generate(model_files, mix):
    path, ref, prompt = model_files(mix)
    params, cfg = tg.load_gguf(path, device="cpu")
    want_cfg = _jax_cfg(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want_cfg)
    assert set(params["layers"][0]) == {*_LAYER_KEYS.values(), "attn_norm",
                                        "mlp_norm"}
    assert params["embed"].dtype == torch.bfloat16
    if mix == "q4_k_m":
        fmts = [params["lm_head"].fmt] + [
            layer[k].fmt for layer in params["layers"]
            for k in ("wv", "w_down", "wq")]
        assert fmts == ["q6_k", "q4_k", "q4_k", "q4_k", "q6_k", "q6_k",
                        "q4_k"]
    _assert_matches(_port_greedy(params, cfg, prompt, 3),
                    _jax_greedy(ref, want_cfg, prompt, 3))


def test_reference_faults_the_port_does_not_inherit(model_files):
    """C.3.4: JAX's loader keeps llama.cpp's Q / K order, so its model
    departs from the original weights' (the port's matches, above and
    here). C.3.3: a quantized token_embd (the Q4_K_M file) becomes a
    QuantLinear embed in JAX, and decoding raises TypeError; the port's
    embed is its dequantized bf16."""
    path, ref, prompt = model_files("q4_k")
    cfg = _jax_cfg(path)
    jparams, _ = jg.load_gguf(path)
    want, _ = jl.prefill(ref, cfg, jnp.asarray(prompt),
                         jl.KVCache.create(cfg, 1, 256))
    got, _ = jl.prefill(jparams, cfg, jnp.asarray(prompt),
                        jl.KVCache.create(cfg, 1, 256))
    want, got = np.asarray(want), np.asarray(got)
    assert np.abs(got - want).max() > 0.1 * np.abs(want).max()

    path, ref, prompt = model_files("q4_k_m")
    jparams, _ = jg.load_gguf(path)
    with pytest.raises(TypeError):
        jl.prefill(jparams, cfg, jnp.asarray(prompt),
                   jl.KVCache.create(cfg, 1, 256))
    params, tcfg = tg.load_gguf(path, device="cpu")
    emb = tg.read_gguf(path).load("token_embd.weight")
    assert torch.equal(params["embed"], tqm.dequantize(
        tqm.from_oracle(emb, "cpu"), torch.bfloat16))
    assert np.array_equal(params["embed"].float().numpy(),
                          np.asarray(ref["embed"], np.float32))


def test_tied_head_and_experts(tmp_path, rng):
    """No output.weight: the head is the quantized embedding (as JAX ties
    it); expert_count > 0 makes a MoE config (tests/test_torch_moe.py loads
    a whole MoE file)."""
    blocks = _blocks(_weights(3), "q4_k_m")
    del blocks["output.weight"]
    path = str(tmp_path / "tied.gguf")
    tg.write_gguf(path, {k: _port(v) if not isinstance(v, np.ndarray) else v
                         for k, v in blocks.items()}, _METADATA)
    params, _ = tg.load_gguf(path, device="cpu")
    head = params["lm_head"]
    assert head.fmt == "q4_k" and head.shape == (CFG.vocab_size, CFG.dim)
    assert torch.equal(tqm.dequantize(head, torch.bfloat16), params["embed"])
    moe = str(tmp_path / "moe.gguf")
    tg.write_gguf(moe, {"output_norm.weight": np.ones(CFG.dim, np.float32)},
                  {**_METADATA, "llama.expert_count": 4})
    params, cfg = tg.load_gguf(moe, device="cpu")
    want = jg.config_from_metadata(jg.read_gguf(moe).metadata)
    assert cfg.is_moe and cfg.n_experts == want.n_experts == 4
    assert cfg.n_active_experts == want.n_active_experts == 2
    assert torch.equal(params["final_norm"].float(), torch.ones(CFG.dim))
