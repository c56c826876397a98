"""The one traffic generator: a mix file's parameters and a seed in, the
requests out.

A mix's lengths are ``points`` fixed quantiles of its distributions, the
midpoints of ``points`` equal strata, so every seed serves the same set of
sizes. Prompt and output points are paired by a fixed permutation (the
same for every seed), and a block serves each pair once, in the order the
seed draws. Blocks follow one another without end, and a window closes at
the end of a block (``run.py``): every window holds whole blocks, the same
work whatever the seed, and seeds change only the order and the tokens.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Iterator

import numpy as np

_MASK = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    prompt_len: int
    steps: int               # tokens served to each sequence (0: prefill)
    tokens: np.ndarray       # int64 [batch, prompt_len]

    @property
    def batch(self) -> int:
        return self.tokens.shape[0]


def quantile(dist: dict, u: float) -> int:
    """The length at quantile u (0 < u < 1) of a length distribution,
    within its ``min`` and ``max`` where it names them."""
    kind = dist["dist"]
    if kind == "fixed":
        return int(dist["value"])
    if kind == "log_normal":
        v = dist["median"] * math.exp(
            dist["sigma"] * statistics.NormalDist().inv_cdf(u))
    elif kind == "log_uniform":
        v = dist["min"] * (dist["max"] / dist["min"]) ** u
    else:
        raise ValueError(f"length distribution {kind!r}: fixed, log_uniform "
                         "or log_normal")
    lo, hi = dist.get("min", 1), dist.get("max", math.inf)
    return int(min(hi, max(lo, round(v))))


def pairs(mix: dict) -> list[tuple[int, int]]:
    """The mix's (prompt length, served tokens) points, one a block slot:
    the i-th prompt point with the output point a fixed permutation puts
    beside it (no output distribution: 0 served tokens, a prefill)."""
    k = int(mix["points"])
    mids = [(i + 0.5) / k for i in range(k)]
    prompts = [quantile(mix["prompt"], u) for u in mids]
    if mix.get("output") is None:
        return [(p, 0) for p in prompts]
    outs = [quantile(mix["output"], u) for u in mids]
    perm = np.random.default_rng(int(mix.get("pairing_seed", 0))) \
        .permutation(k)
    return [(p, outs[j]) for p, j in zip(prompts, perm)]


def lengths(mix: dict, seed: int) -> Iterator[tuple[int, int]]:
    """(prompt length, served tokens) of each request, without end: block
    after block of ``pairs(mix)``, each block in the seed's order."""
    rng = np.random.default_rng([seed & _MASK, 0])
    block = pairs(mix)
    while True:
        for i in rng.permutation(len(block)):
            yield block[i]


def requests(mix: dict, seed: int, vocab: int) -> Iterator[Request]:
    """The mix's requests for ``seed``, without end: each request's tokens
    drawn from the seed and its index alone."""
    batch = int(mix.get("batch", 1))
    for j, (p, o) in enumerate(lengths(mix, seed)):
        rng = np.random.default_rng([seed & _MASK, 1, j])
        yield Request(index=j, prompt_len=p, steps=o,
                      tokens=rng.integers(0, vocab, size=(batch, p),
                                          dtype=np.int64))


def round_up(x: int, m: int) -> int:
    return int(math.ceil(x / m) * m)
