"""SentencePiece-style (llama.cpp "spm") tokenizer.

The port's own copy of the JAX package's ``utils/tokenizer.py``: it reads
the tokenizer llama.cpp embeds in GGUF metadata
(``tokenizer.ggml.tokens`` / ``.scores`` / ``.token_type``) through the
port's ``utils/gguf.read_gguf`` and implements the same greedy
highest-score bigram-merge encoding and byte-fallback decoding, so text in
== text out matches llama.cpp for Llama-family models. Pure Python,
host-side (tokenization is not on the token hot path).

Token types (llama.cpp enum): 1=normal, 2=unknown, 3=control, 6=byte.
"""

from __future__ import annotations

import dataclasses

_SPIECE_SPACE = "▁"     # ▁


@dataclasses.dataclass
class SpmTokenizer:
    tokens: list[str]
    scores: list[float]
    token_type: list[int]
    bos_id: int = 1
    eos_id: int = 2
    unk_id: int = 0
    add_space_prefix: bool = True

    def __post_init__(self):
        self._index = {t: i for i, t in enumerate(self.tokens)}
        self._byte_ids = {}
        for i, (t, tt) in enumerate(zip(self.tokens, self.token_type)):
            if tt == 6 and len(t) == 6 and t.startswith("<0x"):
                self._byte_ids[int(t[3:5], 16)] = i

    # -- construction -------------------------------------------------------

    @classmethod
    def from_gguf_metadata(cls, md: dict) -> "SpmTokenizer":
        model = md.get("tokenizer.ggml.model", "llama")
        if model not in ("llama", "spm"):
            raise ValueError("only SentencePiece tokenizers are supported, "
                             f"got {model!r}")
        toks = md["tokenizer.ggml.tokens"]
        n = len(toks)
        return cls(
            tokens=list(toks),
            scores=list(md.get("tokenizer.ggml.scores", [0.0] * n)),
            token_type=list(md.get("tokenizer.ggml.token_type", [1] * n)),
            bos_id=int(md.get("tokenizer.ggml.bos_token_id", 1)),
            eos_id=int(md.get("tokenizer.ggml.eos_token_id", 2)),
            unk_id=int(md.get("tokenizer.ggml.unknown_token_id", 0)),
            add_space_prefix=bool(
                md.get("tokenizer.ggml.add_space_prefix", True)),
        )

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    # -- encode -------------------------------------------------------------

    def encode(self, text: str, bos: bool = True) -> list[int]:
        """Greedy SentencePiece bigram merge (llama.cpp llm_tokenizer_spm):
        start from single characters, repeatedly merge the adjacent pair
        whose concatenation is the highest-score vocab piece."""
        if self.add_space_prefix and text and not text.startswith(" "):
            text = " " + text
        text = text.replace(" ", _SPIECE_SPACE)
        symbols = list(text)

        def best_pair(syms):
            best, bi = None, -1
            for i in range(len(syms) - 1):
                merged = syms[i] + syms[i + 1]
                idx = self._index.get(merged)
                if idx is not None and self.token_type[idx] == 1:
                    sc = self.scores[idx]
                    if best is None or sc > best:
                        best, bi = sc, i
            return bi

        while len(symbols) > 1:
            i = best_pair(symbols)
            if i < 0:
                break
            symbols[i:i + 2] = [symbols[i] + symbols[i + 1]]

        out = [self.bos_id] if bos else []
        for sym in symbols:
            idx = self._index.get(sym)
            if idx is not None:
                out.append(idx)
                continue
            # byte fallback: UTF-8 bytes of the symbol
            for b in sym.encode("utf-8"):
                out.append(self._byte_ids.get(b, self.unk_id))
        return out

    # -- decode -------------------------------------------------------------

    def decode(self, ids: list[int]) -> str:
        buf = bytearray()
        for i in ids:
            if i in (self.bos_id, self.eos_id):
                continue
            t = self.tokens[i]
            if self.token_type[i] == 6:            # byte token <0xXX>
                buf.append(int(t[3:5], 16))
            elif self.token_type[i] == 3:          # control
                continue
            else:
                buf.extend(t.replace(_SPIECE_SPACE, " ").encode("utf-8"))
        text = buf.decode("utf-8", errors="replace")
        return text[1:] if (self.add_space_prefix
                            and text.startswith(" ")) else text


def load_tokenizer(gguf_path: str) -> SpmTokenizer:
    from ggml_cuda_experiments_tpu_torch.utils.gguf import read_gguf
    return SpmTokenizer.from_gguf_metadata(read_gguf(gguf_path).metadata)
