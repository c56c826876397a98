"""The port's checkpoint files against the JAX package's, on the CPU: the
SPM tokenizer (``utils/tokenizer.py``), the ``.tensor`` dumps
(``utils/tensor_io.py``), the GCTC container (``utils/loader.py``), and the
device quantizer that returns the GGML fields a GGUF writer encodes
(``ops/quant_matmul.quantize_blocks``).

- The tokenizer's ``encode`` / ``decode`` equal the JAX ones on a seeded set
  of strings (byte-fallback text and the empty string among them), and
  ``load_tokenizer`` reads a file the JAX writer made.
- ``.tensor`` files of all four dtypes are interchangeable both ways, byte
  for byte, and the golden file reads as the JAX reader reads it.
- Dense GCTC containers are interchangeable both ways (the same bytes); the
  port's quantized round trip is bit-exact in every format; a JAX file
  holding a quantized tensor is refused; ``load_params(mesh=)`` equals
  ``tp.shard_params`` of the whole tree on each of 2 gloo ranks.
- ``quantize_blocks`` is bit-equal to the port's oracle.

No jax at the top of this module: the gloo ranks import it by name."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu_torch.models import llama as tl
from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as tqm
from ggml_cuda_experiments_tpu_torch.oracle import quant as tq
from ggml_cuda_experiments_tpu_torch.parallel import mesh as pm
from ggml_cuda_experiments_tpu_torch.parallel import tp
from ggml_cuda_experiments_tpu_torch.parallel.launch import run_spmd
from ggml_cuda_experiments_tpu_torch.utils import gguf as tg
from ggml_cuda_experiments_tpu_torch.utils import loader as tload
from ggml_cuda_experiments_tpu_torch.utils import tensor_io as tio
from ggml_cuda_experiments_tpu_torch.utils import tokenizer as ttok

GOLDEN = Path(__file__).resolve().parent / "data" / "golden_debug.tensor"
CFG = PRESETS["debug"]


def _toy(mod):
    """tests/test_tokenizer.py's vocabulary, as ``mod``'s SpmTokenizer."""
    tokens, types, scores = ["<unk>", "<s>", "</s>"], [2, 3, 3], [0.0] * 3
    for b in range(256):
        tokens.append(f"<0x{b:02X}>")
        types.append(6)
        scores.append(0.0)
    pieces = {
        "▁": -2.0, "h": -3.0, "e": -3.0, "l": -3.0, "o": -3.0,
        "he": -1.0, "ll": -1.5, "hell": -0.5, "hello": -0.1,
        "▁hello": -0.05, "▁w": -1.2, "or": -1.3, "ld": -1.4,
        "orld": -0.8, "world": -0.6, "▁world": -0.3,
        "w": -3.0, "r": -3.0, "d": -3.0,
    }
    for p, s in pieces.items():
        tokens.append(p)
        types.append(1)
        scores.append(s)
    return mod.SpmTokenizer(tokens=tokens, scores=scores, token_type=types,
                            bos_id=1, eos_id=2, unk_id=0)


def _strings():
    rng = np.random.default_rng(7)
    alphabet = list("helowrd ") + ["é", "中", "!", "z", "▁", "\n"]
    out = ["", " ", "hello world", "hello zebra!", "héllo 中文"]
    for _ in range(40):
        n = int(rng.integers(1, 24))
        out.append("".join(rng.choice(alphabet, n)))
    return out


def test_tokenizer_matches_jax():
    from ggml_cuda_experiments_tpu.utils import tokenizer as jtok
    port, ref = _toy(ttok), _toy(jtok)
    byte_fallback = 0
    for text in _strings():
        for bos in (True, False):
            ids = port.encode(text, bos=bos)
            assert ids == ref.encode(text, bos=bos), text
            byte_fallback += any(port.token_type[i] == 6 for i in ids)
            assert port.decode(ids) == ref.decode(ids)
    assert byte_fallback and port.decode(port.encode("hello world")) == (
        "hello world")
    ids = np.random.default_rng(8).integers(0, port.vocab_size, 64).tolist()
    assert port.decode(ids) == ref.decode(ids)     # stray bytes replaced


def test_load_tokenizer_reads_a_jax_file(tmp_path):
    from ggml_cuda_experiments_tpu.utils import gguf as jg
    toy = _toy(ttok)
    path = str(tmp_path / "tok.gguf")
    jg.write_gguf(path, {"dummy": np.zeros((4,), np.float32)}, {
        "tokenizer.ggml.model": "llama",
        "tokenizer.ggml.tokens": toy.tokens,
        "tokenizer.ggml.scores": toy.scores,
        "tokenizer.ggml.token_type": toy.token_type,
        "tokenizer.ggml.bos_token_id": 1,
        "tokenizer.ggml.eos_token_id": 2,
        "tokenizer.ggml.add_space_prefix": False,
    })
    tok = ttok.load_tokenizer(path)
    assert (tok.tokens, tok.token_type) == (toy.tokens, toy.token_type)
    assert tok.scores == [float(np.float32(s)) for s in toy.scores]
    assert (tok.bos_id, tok.eos_id, tok.unk_id) == (1, 2, 0)
    assert tok.add_space_prefix is False
    assert tok.decode(tok.encode("hello world")) == "hello world"
    with pytest.raises(ValueError, match="SentencePiece"):
        ttok.SpmTokenizer.from_gguf_metadata({"tokenizer.ggml.model": "gpt2"})


def test_golden_file_reads_as_jax():
    from ggml_cuda_experiments_tpu.utils.tensor_io import load_tensor
    got, name = tio.load_tensor(GOLDEN)
    want, want_name = load_tensor(GOLDEN)
    assert name == want_name and got.dtype == torch.float32
    assert got.shape == want.shape
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16", "int8"])
def test_tensor_files_interchange_with_jax(tmp_path, dtype):
    import ml_dtypes
    from ggml_cuda_experiments_tpu.utils import tensor_io as jio
    x = np.random.default_rng(3).normal(size=(3, 5)) * 10
    x = x.astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)
    t = torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16) \
        if dtype == "bfloat16" else torch.from_numpy(x)
    jpath, tpath = tmp_path / "jax.tensor", tmp_path / "port.tensor"
    jio.save_tensor(jpath, x, dtype)
    tio.save_tensor(tpath, t, dtype)
    assert jpath.read_bytes() == tpath.read_bytes()
    got, name = tio.load_tensor(jpath)
    assert name == dtype and got.dtype == t.dtype and torch.equal(got, t)
    back, name = jio.load_tensor(tpath)
    assert name == dtype and back.dtype == x.dtype
    assert back.tobytes() == x.tobytes()


def _dense_tensors():
    import ml_dtypes
    rng = np.random.default_rng(4)
    return {
        "a": rng.normal(size=(4, 8)).astype(np.float32),
        "b.h": rng.normal(size=(5, 3)).astype(np.float16),
        "b.c": (rng.normal(size=(16,)) * 5).astype(ml_dtypes.bfloat16),
        "d": rng.integers(-100, 100, size=(3, 3)).astype(np.int8),
        "u": rng.integers(0, 255, size=(7,)).astype(np.uint8),
        "i": rng.integers(-10 ** 6, 10 ** 6, size=(2, 2, 2)).astype(
            np.int32),
    }


def _as_torch(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def test_dense_containers_interchange_with_jax(tmp_path):
    from ggml_cuda_experiments_tpu.utils import loader as jload
    tensors = _dense_tensors()
    jpath, tpath = tmp_path / "jax.gctc", tmp_path / "port.gctc"
    jload.save_container(jpath, tensors)
    tload.save_container(tpath, {k: _as_torch(v) for k, v in tensors.items()})
    assert jpath.read_bytes() == tpath.read_bytes()
    for lazy in (True, False):
        got = tload.load_container(jpath, lazy=lazy)
        assert list(got) == list(tensors)
        for k, v in tensors.items():
            assert torch.equal(got[k], _as_torch(v)), k
    back = jload.load_container(tpath)
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and back[k].tobytes() == v.tobytes()


def _leaves(tree, prefix=""):
    """(path, tensor) of every leaf, QuantLinear fields included."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, f"{prefix}.{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{prefix}.{i}")]
    if isinstance(tree, tqm.QuantLinear):
        return [(f"{prefix}#{tree.fmt}#{tree.shape}#{f.name}",
                 getattr(tree, f.name))
                for f in dataclasses.fields(tree)
                if isinstance(getattr(tree, f.name), torch.Tensor)]
    return [(prefix, tree)]


def _same_tree(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return ([k for k, _ in la] == [k for k, _ in lb]
            and all(x.dtype == y.dtype and torch.equal(x, y)
                    for (_, x), (_, y) in zip(la, lb)))


@pytest.mark.parametrize("fmt", tqm.FORMATS)
def test_quantized_params_round_trip(tmp_path, fmt):
    params = tl.quantize_params(tl.init_weights(CFG, seed=2, device="cpu"),
                                fmt, head_fmt="q6_k" if fmt == "q4_k" else None)
    path = tmp_path / "model.gctc"
    tload.save_params(path, params)
    back = tload.load_params(path, device="cpu")
    assert _same_tree(back, params)
    assert back["layers"][0]["wqkv"].fmt == fmt
    assert "+logical#" in next(iter(
        k for k in tload.load_container(path) if "#" in k))


def test_a_jax_quantized_file_is_refused(tmp_path):
    from ggml_cuda_experiments_tpu.models import llama as jl
    from ggml_cuda_experiments_tpu.models.config import PRESETS as JPRESETS
    from ggml_cuda_experiments_tpu.utils import loader as jload
    params = jl.init_weights(JPRESETS["debug"], seed=2)
    path = tmp_path / "jax.gctc"
    jload.save_params(path, {"lm_head": jl.quantize_params(
        params, "q8_0")["lm_head"], "final_norm": params["final_norm"]})
    with pytest.raises(ValueError, match="re-quantize from the source"):
        tload.load_params(path, device="cpu")


def _shard_rank(path):
    """On this rank: load_params(mesh=) and tp.shard_params of the whole
    tree, and whether they agree leaf for leaf."""
    mesh = pm.make_mesh(model=2)
    got = tload.load_params(path, mesh=mesh, device="cpu")
    want = tp.shard_params(tload.load_params(path, device="cpu"), mesh)
    return {"same": _same_tree(got, want),
            "wq": tuple(got["layers"][0]["wq"].qs.shape),
            "wo": tuple(got["layers"][0]["wo"].qs.shape)}


def test_load_params_with_a_mesh(tmp_path):
    """An unfused q8_0 tree (the row-parallel K-shards are whole 32-blocks)
    over a model = 2 mesh of 2 gloo ranks."""
    params = tl.quantize_params(tl.init_weights(CFG, seed=3, device="cpu"),
                                "q8_0", fuse=False)
    path = str(tmp_path / "model.gctc")
    tload.save_params(path, params)
    ranks = run_spmd(_shard_rank, 2, "gloo", "cpu", 120, args=(path,))
    hd = CFG.n_heads * CFG.head_dim
    for r in ranks:
        assert r["same"]
        assert r["wq"] == (hd // 2, CFG.dim)
        assert r["wo"] == (CFG.dim, hd // 2)


def _with_ties(w):
    """Blocks whose largest |x| ties +v and -v (either sign first), a zero
    block and a constant one."""
    w = w.copy()
    w[0, :32] = 0.01
    w[0, 3], w[0, 9] = 0.5, -0.5
    w[1, :32] = -0.02
    w[1, 20], w[1, 21] = -0.25, 0.25
    w[2, :256] = 0.0
    w[3, :256] = 0.125
    return w


@pytest.mark.parametrize("fmt", tqm.FORMATS)
def test_quantize_blocks_bit_equal_to_the_oracle(fmt):
    rng = np.random.default_rng(9)
    w = _with_ties((rng.normal(size=(40, 512)) / 20).astype(np.float32))
    got = tqm.quantize_blocks(torch.from_numpy(w), fmt)
    want = getattr(tq, f"quantize_{fmt}")(w)
    assert type(got) is type(want) and got.shape == want.shape
    for f in dataclasses.fields(want):
        if f.name != "shape":
            a, b = getattr(got, f.name), getattr(want, f.name)
            assert a.numpy().dtype == b.dtype, f.name
            assert np.array_equal(a.numpy(), b), f.name
    assert tqm.block_format(got) == fmt
    ql = tqm.quantize(torch.from_numpy(w), fmt)
    assert _same_tree(ql, tqm.from_oracle(want, device="cpu"))
