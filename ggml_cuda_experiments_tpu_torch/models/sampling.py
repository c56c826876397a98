"""Token sampling: greedy / temperature / top-k / top-p (nucleus).

Port of the reference's ``models/sampling.py``. Everything stays on the
logits' device, with static shapes and no host sync, so a sampled token can
feed the next decode step directly. Random draws come from the explicit
``torch.Generator`` the caller passes (on the logits' device), as Gumbel-max
over the masked logits: an exact draw from the categorical, like the
reference's ``jax.random.categorical``, but not JAX's PRNG bits: the same
seed gives the same tokens within the port, not the reference's tokens.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 1.0     # 0 => greedy
    top_k: int = 0               # 0 => disabled
    top_p: float = 1.0           # 1 => disabled


def _mask_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest logits, -inf the rest (ties keep all tied)."""
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits >= kth, logits, -torch.inf)


def _mask_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus: keep the smallest prefix of descending-prob tokens whose
    cumulative probability exceeds p (the first token is always kept)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < p             # mass BEFORE this token is < p
    thresh = torch.where(keep, sorted_logits, torch.inf).amin(
        dim=-1, keepdim=True)            # smallest kept logit
    return torch.where(logits >= thresh, logits, -torch.inf)


def sample(logits: torch.Tensor, generator: torch.Generator | None,
           params: SamplingParams = SamplingParams()) -> torch.Tensor:
    """logits [..., vocab] -> int32 token ids [...]. Greedy when
    temperature == 0 (the generator is then unused)."""
    if params.temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    x = logits.float() / params.temperature
    if params.top_k and params.top_k > 0:
        x = _mask_top_k(x, params.top_k)
    if params.top_p < 1.0:
        x = _mask_top_p(x, params.top_p)
    u = torch.rand(x.shape, generator=generator, device=x.device)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(x + gumbel, dim=-1).to(torch.int32)
