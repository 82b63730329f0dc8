"""Sampling parameters of the paged serving engine - greedy only.

``SamplingParams`` is the reference's dataclass unchanged, so requests
read the same in both packages.  The port's engine serves
``temperature == 0`` with no repetition penalty (plain argmax) and
rejects anything else at submit time: seeded sampling needs the
reference's threefry streams in torch (ROADMAP.md Queue 1 item 7).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration (host-side, hashable)."""
    temperature: float = 0.0      # 0 => greedy argmax
    top_k: int = 0                # 0 => disabled
    top_p: float = 1.0            # 1 => disabled
    repetition_penalty: float = 1.0
    seed: int = 0

    def __post_init__(self):
        assert self.temperature >= 0.0, self.temperature
        assert self.top_k >= 0, self.top_k
        assert 0.0 < self.top_p <= 1.0, self.top_p
        assert self.repetition_penalty > 0.0, self.repetition_penalty

    @property
    def greedy(self) -> bool:
        """Plain argmax: temperature 0 and no repetition penalty (top-k
        and top-p do not change an argmax)."""
        return self.temperature == 0.0 and self.repetition_penalty == 1.0


GREEDY = SamplingParams()


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the last axis as int32 (first index on ties, as
    ``jnp.argmax``)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
