"""The check that decides ``correct``: the answers the window served,
against the configuration's plain reference on the same weights and
prompts, both drawn again from the seed once the program's state is gone.

An answer is the (batch, 8) logits of the last position. Its gap is the
largest distance of one of its logits from the reference's, in units of
the spread (standard deviation over the whole vocabulary) of that row of
the reference's logits. ``logit_gap`` is the largest gap over the answers
compared; an invocation that failed or never answered counts in
``failed``, whose limit is 0.

Every answer is compared whose (function, prompt) pair is among those
sampled: all of them where the window served at most ``MAX_PAIRS``, else
``MAX_PAIRS`` drawn from the seed, one of each function served first, so
that the reference's time stays under the window's."""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch

from harness import traffic, weights


def gap(answer, ref: torch.Tensor) -> float:
    """The answer's gap to ``ref`` (batch, vocab) float32."""
    a = torch.as_tensor(answer, dtype=torch.float32, device=ref.device)
    k = a.shape[-1]
    scale = ref.std(dim=-1, keepdim=True)
    return float(((a - ref[:, :k]).abs() / scale).max())


MAX_PAIRS = 48


def references(config: dict, mix: dict, seed: int, device, reference,
               wanted: Iterable[Tuple[int, int]], precision: str = "fp32"
               ) -> Dict[Tuple[int, int], torch.Tensor]:
    """The reference's last-position logits of each (function, prompt) pair
    in ``wanted``; one function's weights at a time."""
    m = config["model"]
    wanted = sorted(set(wanted))
    prompts = traffic.prompts(mix, m["vocab_size"], seed, device)
    out = {}
    for f in sorted({f for f, _ in wanted}):
        W = weights.make(reference.layout(m), seed, device, function=f)
        for g, p in wanted:
            if g == f:
                out[(f, p)] = reference.forward_last(W, prompts[p], m, precision)
        del W
    del prompts
    return out


def sample_pairs(pairs: Iterable[Tuple[int, int]], seed: int) -> List[Tuple[int, int]]:
    """The (function, prompt) pairs compared: all, or ``MAX_PAIRS`` of them
    drawn from ``seed``, the first of each function's before any second."""
    pairs = sorted(set(pairs))
    if len(pairs) <= MAX_PAIRS:
        return pairs
    shuffled = [pairs[i] for i in traffic.rng(seed, 4).permutation(len(pairs))]
    seen, first, rest = set(), [], []
    for f, p in shuffled:
        (rest if f in seen else first).append((f, p))
        seen.add(f)
    return sorted((first + rest)[:MAX_PAIRS])


def check(config: dict, mix: dict, seed: int, device, reference, invocations) -> dict:
    """The numbers compared, each with its limit, and ``correct``."""
    answered = [v for v in invocations if v.answer is not None and v.error is None]
    failed = sum(1 for v in invocations if v.answer is None or v.error is not None)
    pairs = set(sample_pairs([(v.function, v.prompt) for v in answered], seed))
    compared = [v for v in answered if (v.function, v.prompt) in pairs]
    refs = references(config, mix, seed, device, reference, pairs)
    worst = max((gap(v.answer, refs[(v.function, v.prompt)]) for v in compared),
                default=float("inf"))
    limit = float(config["check"]["logit_gap"])
    numbers = {
        "logit_gap": {"value": worst, "limit": limit},
        "failed": {"value": failed, "limit": 0},
    }
    correct = worst <= limit and failed == 0
    return {"correct": correct, "numbers": numbers, "compared": len(compared),
            "pairs": len(pairs)}
