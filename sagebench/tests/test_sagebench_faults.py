"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run (``runner.run_cell``, then
``check.check``) on the CPU at a reduced size, past the harness's look for a
card, with one fault planted in the program's forward as the function's
context calls it (``repro_torch.core.functions.forward``):

* ``stale``: every answer is the first invocation's, not recomputed (a step
  that returns its state unchanged);
* ``half_batch``: half of the rows are computed and the rest given their
  mean;
* ``token``: one token of the prompt altered before the forward;
* ``answer``: two of the answer's logits swapped where they are produced.

and, on a node of three functions, ``other_weights``: every function
served with the first one's weights.

The exchange between chips has no fault to plant: every cell runs on one."""
import copy
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

from harness import check, manifest, runner  # noqa: E402

TINY = dict(num_layers=2, d_model=64, ssm_state=16, ssm_headdim=16, ssm_chunk=16,
            vocab_size=96)
MIX = {"loop": "open", "rate_per_s": 20.0, "schedule_seed": 1, "batch": 4, "seq": 32,
       "prompts": 3, "warm_invocations": 1}


def stale(forward):
    first = []

    def f(cfg, p, batch):
        out = forward(cfg, p, batch)
        if not first:
            first.append(out)
        return first[0]
    return f


def half_batch(forward):
    def f(cfg, p, batch):
        t = batch["tokens"]
        logits, aux = forward(cfg, p, {"tokens": t[: t.shape[0] // 2]})
        rest = logits.mean(0, keepdim=True).expand(t.shape[0] - logits.shape[0], -1, -1)
        return torch.cat([logits, rest]), aux
    return f


def token(forward):
    def f(cfg, p, batch):
        t = batch["tokens"].clone()
        t[0, -1] = (t[0, -1] + 1) % cfg.vocab_size
        return forward(cfg, p, {"tokens": t})
    return f


def answer(forward):
    def f(cfg, p, batch):
        logits, aux = forward(cfg, p, batch)
        logits = logits.clone()
        logits[0, -1, [0, 7]] = logits[0, -1, [7, 0]]
        return logits, aux
    return f


def run(fault=None, seed=5, mix=MIX, weights_of=None):
    from repro_torch.core import functions

    doc = copy.deepcopy(manifest.config("mamba2-780m"))
    doc["model"].update(TINY)
    ref = manifest.reference("mamba2-780m")
    real, make = functions.forward, runner.weights.make
    if fault is not None:
        functions.forward = fault(real)
    if weights_of is not None:
        runner.weights.make = lambda *a, function=0: make(*a, function=weights_of)
    try:
        out = runner.run_cell(doc, mix, seed=seed, seconds=0.4, trace=False, device="cpu",
                              log=lambda obj: None, reference=ref)
    finally:
        functions.forward, runner.weights.make = real, make
    return check.check(doc, mix, seed, "cpu", ref, out["invocations"])


def test_a_sound_run_is_correct():
    verdict = run()
    assert verdict["correct"], verdict
    assert verdict["numbers"]["failed"]["value"] == 0


@pytest.mark.parametrize("fault", [stale, half_batch, token, answer],
                         ids=lambda f: f.__name__)
def test_a_broken_run_is_not_correct(fault):
    verdict = run(fault)
    assert not verdict["correct"], verdict
    gap = verdict["numbers"]["logit_gap"]
    assert gap["value"] > gap["limit"]


MIX3 = dict(MIX, functions=3, zipf_s=1.0)


def test_a_sound_run_over_three_functions_is_correct():
    verdict = run(mix=MIX3)
    assert verdict["correct"], verdict
    assert verdict["pairs"] > 3 and verdict["compared"] >= verdict["pairs"]


def test_functions_served_with_another_s_weights_are_not_correct():
    verdict = run(mix=MIX3, weights_of=0)
    assert not verdict["correct"], verdict
    gap = verdict["numbers"]["logit_gap"]
    assert gap["value"] > gap["limit"]
