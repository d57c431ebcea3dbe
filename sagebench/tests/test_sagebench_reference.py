"""Each configuration's plain reference against the program's forward at a
reduced size, both in float32 on the CPU, on the weights the harness makes.
The program is imported here only: the references import nothing of it."""
import copy
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

from harness import check, counts, manifest, traffic, weights  # noqa: E402

SMALL = {
    "olmoe-1b-7b": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
                        d_ff=32, expert_d_ff=32, vocab_size=96, num_experts=8,
                        experts_per_token=2, moe_capacity_factor=1.0),
    "mamba2-780m": dict(num_layers=2, d_model=64, ssm_state=16, ssm_headdim=16, ssm_chunk=16,
                        vocab_size=96),
}


def small(name, dtype="float32"):
    doc = copy.deepcopy(manifest.config(name))
    doc["model"].update(SMALL[name], param_dtype=dtype, compute_dtype=dtype)
    return doc


def program_last(m, W, tokens):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import forward

    with torch.inference_mode():
        return forward(ModelConfig(**m), W, {"tokens": tokens})[0][:, -1].float()


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("seed", [3, 2**31 + 9])
def test_reference_matches_the_program_in_float32(name, seed):
    m = small(name)["model"]
    ref = manifest.reference(name)
    layout = [(p, s, "float32", r) for p, s, _, r in ref.layout(m)]
    W = weights.make(layout, seed, "cpu")
    tokens = traffic.prompts({"batch": 2, "seq": 40, "prompts": 1}, m["vocab_size"], seed, "cpu")[0]
    want = program_last(m, W, tokens)
    got = ref.forward_last(W, tokens, m)
    assert got.shape == want.shape == (2, m["vocab_size"])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


def test_the_olmoe_reference_drops_past_capacity():
    m = small("olmoe-1b-7b")["model"]
    ref = manifest.reference("olmoe-1b-7b")
    E, D, F = m["num_experts"], m["d_model"], m["expert_d_ff"]
    S = 40
    assert ref.capacity(m, S) == 10
    # every token routes to experts 0 and 1: only the first 10 choices of each are kept
    x = torch.rand(1, S, D) + 0.1
    router = torch.zeros(D, E)
    router[:, :2] = 1.0
    y = ref.moe(x, router, torch.ones(E, D, F), torch.ones(E, D, F), torch.ones(E, F, D), m,
                lambda a, b: a @ b)
    kept = (y.abs().sum(-1) > 0)[0]
    assert kept[:10].all() and not kept[10:].any()


CONTROL = {  # sizes at which a test run holds the control, and its three seeds
    "olmoe-1b-7b": dict(num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
                        d_ff=128, expert_d_ff=128, vocab_size=512, num_experts=8,
                        experts_per_token=2, moe_capacity_factor=1.25),
    "mamba2-780m": dict(num_layers=32, d_model=64, ssm_state=16, ssm_headdim=16, ssm_chunk=16,
                        vocab_size=256),
}


@pytest.mark.parametrize("name", sorted(CONTROL))
def test_the_program_in_bf16_passes_and_the_fp8_control_fails(name):
    """The control of the check at a size a test run holds: the program in
    bf16 and the reference with fp8 products, each judged against the
    float32 reference by ``check.gap`` with the configuration's limit, on
    three seeds. (At the cells' size the control ran on the card:
    ``tools/control.py``; a shallower stack reads a smaller control gap.)"""
    doc = copy.deepcopy(manifest.config(name))
    doc["model"].update(CONTROL[name])
    m = doc["model"]
    ref = manifest.reference(name)
    limit = doc["check"]["logit_gap"]
    program, control = [], []
    for seed in (11, 12, 13):
        W = weights.make(ref.layout(m), seed, "cpu")
        tokens = traffic.prompts({"batch": 2, "seq": 64, "prompts": 1}, m["vocab_size"], seed,
                                 "cpu")[0]
        want = ref.forward_last(W, tokens, m)
        program.append(check.gap(program_last(m, W, tokens)[:, :8].numpy(), want))
        control.append(check.gap(ref.forward_last(W, tokens, m, "fp8")[:, :8].numpy(), want))
    assert max(program) <= limit < min(control), (program, limit, control)


def test_flops_match_hand_counts_at_published_shapes():
    ol = manifest.config("olmoe-1b-7b")["model"]
    T = 4 * 1024
    per_layer = (2 * T * (2048 * 2048 * 4)             # q, k, v, o projections
                 + 2 * T * 2048 * 64                   # the router
                 + 2 * T * 8 * 3 * 2048 * 1024         # 8 experts, SwiGLU
                 + 4 * 4 * 16 * 128 * (1024 * 1025 // 2))  # causal QK^T and PV
    want = 16 * per_layer + 2 * T * 2048 * 50304
    assert counts.model_flops(ol, 4, 1024)["total"] == pytest.approx(want, rel=1e-12)
    mb = manifest.config("mamba2-780m")["model"]
    chunk = 2 * 4 * (8256 * 128 + 48 * (8256 * 64 + 2 * 128 * 128 * 64))  # t = 128
    per_layer = 2 * T * (1536 * (2 * 3072 + 2 * 128 + 48) + 3072 * 1536) + 8 * chunk
    want = 48 * per_layer + 2 * T * 1536 * 50288
    assert counts.model_flops(mb, 4, 1024)["total"] == pytest.approx(want, rel=1e-12)


def test_kernel_bounds_match_hand_counts_and_the_ports_arithmetic():
    from repro_torch.analysis import roofline

    att = counts.attention_call(4, 1024, 16, 16, 128)
    assert att["flops"] == 4.0 * 4 * 16 * 128 * 524800
    assert att["bytes"] == (2 * 4 * 1024 * 16 * 128 * 2) * 2
    assert att["bound_s"] == pytest.approx(max(att["flops"] / 989e12, att["bytes"] / 3.35e12))
    port = roofline.attention_bound_ms((4, 1024, 1024, 16, 16, 128, True), torch.bfloat16)
    assert port[0] == pytest.approx(att["bound_s"] * 1e3) and port[2] == att["flops"]
    ssd = counts.ssd_call(4, 1024, 48, 64, 128, 128)
    port = roofline.ssd_bound_ms((4, 1024, 48, 64, 128, 128), torch.bfloat16)
    assert port[0] == pytest.approx(ssd["bound_s"] * 1e3) and port[2] == ssd["flops"]
    assert port[3] == ssd["bytes"]
