"""Which served sequences the reference judges, and the number compared.

Once the window has closed, a sample drawn from the seed of the sequences
it finished, with the longest among them, is run through the reference.
At each judged position the gap is how far the served token's logit lies
below the reference's best logit there (greedy tokens: a token the
reference ranks first has gap 0). A cell's limits file names the numbers
compared: the widest gap, or the mean gap over the judged positions, which
holds where a few near-ties in random weights make the widest gap of sound
runs and of the control alike.
"""

from __future__ import annotations

import numpy as np

from port_bench.lib.reference import Judged

_MASK = (1 << 64) - 1


def sample(done: list, mix: dict, seed: int) -> list[Judged]:
    """``done``: (request, served tokens [batch, n]) of every request the
    window finished. Returns the judged sequences: the longest, then the
    rest of ``judged_requests`` drawn from the seed."""
    cands = [(req, row, out) for req, out in done for row in range(req.batch)]
    if not cands:
        return []
    order = sorted(range(len(cands)), key=lambda i: (
        -cands[i][0].steps, -cands[i][0].prompt_len, i))
    rest = order[1:]
    rng = np.random.default_rng([seed & _MASK, 2])
    n = min(int(mix["judged_requests"]), len(cands))
    picked = [order[0]] + [rest[i] for i in
                           rng.choice(len(rest), n - 1, replace=False)]
    out = []
    for i in picked:
        req, row, served = cands[i]
        prompt = req.tokens[row]
        toks = [int(t) for t in served[row]]
        t = req.prompt_len
        feed = np.concatenate([prompt, np.asarray(toks[:-1], np.int64)])
        out.append(Judged(tokens=feed,
                          positions=[t - 1 + j for j in range(len(toks))],
                          served=toks))
    return out


def control_precision(spec, mix: dict) -> str:
    """The precision one step below what the configuration states for the
    products that yield the judged tokens: a batch-1 decode's rows, or
    the rows of a batch or a prompt."""
    from port_bench.lib.reference import BELOW
    one_row = mix["entry"] == "generate_scan" and int(mix.get("batch", 1)) == 1
    return BELOW[spec.precision_rows1 if one_row else spec.precision_rows]


def readings(gaps: dict) -> dict:
    """The numbers a limit can hold, of the served tokens and of the
    control's: the widest and the mean gap over the judged positions."""
    def numbers(xs):
        return {"widest_logit_gap": max(xs),
                "mean_logit_gap": sum(xs) / len(xs)}
    ctrl = gaps["control"]
    return {**numbers(gaps["served"]),
            "control": numbers(ctrl) if ctrl else None,
            "judged": len(gaps["served"])}
