"""The one traffic generator: reads a mix's parameters (``traffic/<name>.json``)
and gives, from a seed, the prompts and the order and times of the
invocations.

Parameters of a mix:

* ``loop``: ``"open"`` (invocations are due on a schedule, whatever the
  system does) or ``"closed"`` (each client sends its next invocation as
  soon as its last one returns);
* ``rate_per_s`` (open): the mean arrival rate, Poisson;
* ``clients`` (closed): how many clients;
* ``fresh_node`` (closed): every invocation goes to a new node (a new
  ``SageRuntime`` over the same host database), so every one is cold;
* ``batch``, ``seq``: each invocation's tokens, ``batch`` rows of ``seq``;
* ``prompts``: how many distinct token sets a run draws; invocation ``i``
  sends prompt ``order[i % prompts]``;
* ``warm_invocations``: warm invocations served in set-up, after the cold;
* ``schedule_seed`` (open): the seed of the arrival schedule;
* ``functions``: how many distinct functions the node holds (default 1),
  each the configuration with weights of its own drawn from the run's
  seed; invocation ``i`` goes to ``function_order(mix)[i % ORDER_LEN]``;
* ``zipf_s``: the functions' popularity, function ``k``'s share in
  proportion to ``1 / (k + 1) ** zipf_s`` (0: all alike);
* ``burst`` (open): ``{"on_s", "period_s"}``: arrivals fall only in the
  first ``on_s`` seconds of each ``period_s``, at ``rate_per_s`` within
  those windows;
* ``compute``: the node's compute plane, an object handed to
  ``SageRuntime(compute=...)`` (absent: the runtime's default, one
  invocation's forward at a time under the node's lock).

An open schedule's gaps are the quantiles of the exponential distribution
at (i + 1/2) / n, n = rate x seconds, shuffled by ``schedule_seed`` and
scaled to fill the window (with ``burst``: the on-windows' seconds laid end
to end, then each due time moved into its own on-window). So every run of
a mix sends the same invocations at the same times, a fixed sample of
Poisson arrivals, whatever its seed: the order of the gaps sets how the
queue builds, and with the order drawn from each run's seed the tails of
runs at the same load spread by 30 % (an
H100 80GB HBM3, 7.1 invocations/s of mamba2-780m). The run's seed draws the
weights, the prompts and their order. The functions' order is fixed by the
mix alone (``schedule_seed``), so every run's seed sends each function the
same invocations."""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from harness import weights

KEYS = {"loop", "rate_per_s", "clients", "fresh_node", "batch", "seq", "prompts",
        "warm_invocations", "schedule_seed", "functions", "zipf_s", "burst", "compute", "about"}
ORDER_LEN = 1000


def validate(mix: dict) -> dict:
    unknown = set(mix) - KEYS
    if unknown:
        raise ValueError(f"unknown traffic keys {sorted(unknown)}")
    if mix["loop"] == "open":
        if not mix.get("rate_per_s", 0) > 0 or "schedule_seed" not in mix:
            raise ValueError("an open loop needs rate_per_s > 0 and a schedule_seed")
    elif mix["loop"] == "closed":
        if not mix.get("clients", 0) >= 1:
            raise ValueError("a closed loop needs clients >= 1")
    else:
        raise ValueError(f"loop must be open or closed, not {mix['loop']!r}")
    if "burst" in mix:
        burst = mix["burst"]
        if (mix["loop"] != "open" or not isinstance(burst, dict)
                or set(burst) != {"on_s", "period_s"}
                or not 0 < float(burst["on_s"]) <= float(burst["period_s"])):
            raise ValueError("a burst is {on_s, period_s} with 0 < on_s <= period_s, "
                             "in an open loop")
    if "compute" in mix and not isinstance(mix["compute"], dict):
        raise ValueError("compute must be an object of the runtime's compute settings")
    for k in ("batch", "seq", "prompts"):
        if not int(mix[k]) >= 1:
            raise ValueError(f"{k} must be >= 1")
    n = int(mix.get("functions", 1))
    if not 1 <= n <= ORDER_LEN // 10 or float(mix.get("zipf_s", 0.0)) < 0:
        raise ValueError(f"functions must lie in [1, {ORDER_LEN // 10}] and zipf_s >= 0")
    if n > 1 and mix.get("fresh_node"):
        raise ValueError("a mix of fresh nodes serves one function")
    if min(function_order(mix).count(f) for f in range(n)) < 1:
        raise ValueError("every function needs a share of the order")
    return mix


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def open_schedule(rate: float, seconds: float, seed: int,
                  burst: Optional[dict] = None) -> List[float]:
    """Due times in [0, seconds) of an open Poisson loop at ``rate``; with
    ``burst``, only in the first ``on_s`` of each ``period_s``."""
    on = seconds
    if burst is not None:
        on_s, period_s = float(burst["on_s"]), float(burst["period_s"])
        whole = math.floor(seconds / period_s)
        on = whole * on_s + min(on_s, seconds - whole * period_s)
    n = max(1, int(round(rate * on)))
    gaps = np.array([-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)])
    gaps = gaps[rng(seed, 1).permutation(n)]
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]]) * (on / gaps.sum())
    if burst is not None:
        k = np.floor(due / on_s)
        due = k * period_s + np.clip(due - k * on_s, 0.0, on_s)
    return list(due)


def prompt_order(n_prompts: int, seed: int) -> List[int]:
    """The prompts' order: invocation i sends ``order[i % n_prompts]``."""
    return [int(i) for i in rng(seed, 2).permutation(n_prompts)]


def function_order(mix: dict) -> List[int]:
    """The functions' order: ``ORDER_LEN`` entries, function ``k`` in
    proportion to ``1 / (k + 1) ** zipf_s`` (the largest remainders rounded
    up), shuffled by the mix's ``schedule_seed``."""
    n = int(mix.get("functions", 1))
    if n == 1:
        return [0]
    share = 1.0 / np.arange(1, n + 1) ** float(mix.get("zipf_s", 0.0))
    raw = share / share.sum() * ORDER_LEN
    counts = np.floor(raw).astype(int)
    counts[np.argsort(counts - raw, kind="stable")[:ORDER_LEN - counts.sum()]] += 1
    seq = np.repeat(np.arange(n), counts)
    return [int(f) for f in seq[rng(int(mix.get("schedule_seed", 0)), 3).permutation(ORDER_LEN)]]


def prompts(mix: dict, vocab: int, seed: int, device) -> torch.Tensor:
    """(prompts, batch, seq) int32 token ids drawn on ``device`` from ``seed``."""
    g = weights.generator(seed, torch.device(device), 100)
    return torch.randint(0, vocab, (int(mix["prompts"]), int(mix["batch"]), int(mix["seq"])),
                         generator=g, device=device, dtype=torch.int32)
