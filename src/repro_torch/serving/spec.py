"""Self-speculative draft proposal: prompt-lookup / n-gram matching.

The proposer suggests up to k continuation tokens for a request from the
request's *own* token history (prompt + everything generated so far):
find the most recent earlier occurrence of the stream's trailing n-gram
(longest n first) and propose the tokens that followed it.  No draft
model, no extra forward pass - the only cost is the host-side scan.

This is the PLD/lookahead-lite scheme: it wins exactly where serving
workloads repeat themselves (copied spans, templated output, greedy
cycles), and because the verify step scores every draft against the
target model's own logits, a wrong draft costs one discarded column -
acceptance is *exact*, never approximate.

Pure host logic - fully testable without a device.
"""
from __future__ import annotations


def propose_draft(tokens: list[int], k: int, *, max_ngram: int = 3,
                  min_ngram: int = 1) -> list[int]:
    """Propose up to ``k`` tokens continuing ``tokens``.

    Scans for the most recent earlier occurrence of the stream's
    trailing n-gram, preferring longer n-grams (``max_ngram`` down to
    ``min_ngram``), and returns the up-to-k tokens that followed that
    occurrence.  Returns [] when history offers no match (caller falls
    back to plain one-token decode).
    """
    n = len(tokens)
    if k <= 0 or n < min_ngram + 1:
        return []
    for g in range(min(max_ngram, n - 1), min_ngram - 1, -1):
        tail = tokens[n - g:]
        for start in range(n - g - 1, -1, -1):
            if tokens[start:start + g] == tail:
                # The match says the stream repeats with period
                # d = n - g - start; a match flush against the tail
                # (constant run / short cycle - the dominant greedy
                # case) leaves fewer than k history tokens after it, so
                # extend the continuation periodically: the token at
                # stream position n + j is predicted by position
                # n + j - d, which may itself be a draft.
                d = n - g - start
                out: list[int] = []
                for j in range(k):
                    idx = start + g + j
                    out.append(tokens[idx] if idx < n else out[j - d])
                return out
    return []
