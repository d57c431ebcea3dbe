"""Each configuration's plain reference against the program's forward at a
reduced size, both in float32 on the CPU, on the weights the harness makes.
The program is imported here only: the references import nothing of it.
Each configuration's file gives the sizes: ``small`` for the comparison,
``control`` for the fp8 control."""
import copy
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

from harness import check, counts, manifest, traffic, weights  # noqa: E402

CONFIGS = sorted(c["name"] for c in manifest.benchmark()["configs"])


def small(name, dtype="float32"):
    doc = copy.deepcopy(manifest.config(name))
    doc["model"].update(doc["small"], param_dtype=dtype, compute_dtype=dtype)
    return doc


def program_last(m, W, tokens):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import forward

    with torch.inference_mode():
        return forward(ModelConfig(**m), W, {"tokens": tokens})[0][:, -1].float()


@pytest.mark.parametrize("name", CONFIGS)
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


@pytest.mark.parametrize("name", CONFIGS)
def test_the_program_in_bf16_passes_and_the_fp8_control_fails(name):
    """The control of the check at a size a test run holds (the file's
    ``control``): the program in bf16 and the reference with fp8 products,
    each judged against the float32 reference by ``check.gap`` with the
    configuration's limit, on three seeds. (At the cells' size the control
    ran on the card: ``tools/control.py``; a shallower stack reads a
    smaller control gap.)"""
    doc = copy.deepcopy(manifest.config(name))
    doc["model"].update(doc["control"])
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


T = 4 * 1024

# jamba's pattern (attention every 8th layer, experts every 2nd) at small widths
JAMBA = dict(name="jamba-pattern", family="hybrid", num_layers=16, d_model=256, num_heads=4,
             num_kv_heads=2, head_dim=64, d_ff=512, expert_d_ff=384, vocab_size=1000,
             num_experts=8, experts_per_token=2, moe_every=2, attn_every=8, ssm_state=16,
             ssm_headdim=32, ssm_expand=2, ssm_chunk=64)
# granite-4.0-h-small's published widths, cut to two of its four periods (20 layers);
# the shared expert has a width of its own
GRANITE_CUT = dict(name="granite-cut", family="hybrid", num_layers=20, d_model=4096,
                   num_heads=32, num_kv_heads=8, head_dim=128, d_ff=768, expert_d_ff=768,
                   vocab_size=100352, num_experts=72, experts_per_token=10, moe_every=1,
                   moe_shared_expert=True, shared_expert_d_ff=1536, attn_every=10,
                   ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=128)


def test_layer_kinds_follow_the_ports_period_arithmetic():
    import dataclasses

    from repro_torch.configs.base import ModelConfig

    known = {f.name for f in dataclasses.fields(ModelConfig)}
    for m in (JAMBA, GRANITE_CUT, manifest.config("olmoe-1b-7b")["model"],
              manifest.config("mamba2-780m")["model"]):
        cfg = ModelConfig(**{k: v for k, v in m.items() if k in known})
        want = [(s.mixer, s.ffn) for s in cfg.period_spec()] * cfg.num_periods
        assert counts.layer_kinds(m) == want, m["name"]
    period = [("attn", "dense")] + [("mamba", "moe"), ("mamba", "dense")] * 3 + [("mamba", "moe")]
    assert counts.layer_kinds(JAMBA) == period * 2
    assert counts.layer_kinds(GRANITE_CUT) == ([("attn", "moe")] + [("mamba", "moe")] * 9) * 2
    assert counts.mixers(JAMBA) == {"attn", "mamba"}
    with pytest.raises(ValueError):
        counts.layer_kinds(dict(JAMBA, num_layers=12))


def test_flops_of_hybrids_match_hand_counts():
    # jamba's pattern, (2, 128) tokens: 2 attention and 14 Mamba2 mixers, 8 MoE and 8 dense FFNs
    t = 2 * 128
    mamba = 2 * t * (256 * (2 * 512 + 2 * 16 + 16) + 512 * 256)
    ssd = 2 * (2 * 2 * (2080 * 16 + 16 * (2080 * 32 + 2 * 64 * 16 * 32)))  # 2 chunks of 64
    attn = 2 * t * (256 * 4 * 64 * 2 + 256 * 2 * 64 * 2) + 4 * 2 * 4 * 64 * (128 * 129 // 2)
    dense = 2 * t * 3 * 256 * 512
    moe = 2 * t * (2 * 3 * 256 * 384 + 256 * 8)
    want = 14 * (mamba + ssd) + 2 * attn + 8 * dense + 8 * moe + 2 * t * 256 * 1000
    got = counts.model_flops(JAMBA, 2, 128)
    assert got["total"] == pytest.approx(want, rel=1e-12)
    assert got["ssd"] == pytest.approx(14 * ssd, rel=1e-12)
    # granite's cut, 4 x 1024 tokens: 18 Mamba2 and 2 attention mixers, 20 MoE FFNs each
    # with the shared SwiGLU of width 1536
    mamba = 2 * T * (4096 * (2 * 8192 + 2 * 128 + 128) + 8192 * 4096)
    ssd = 8 * (2 * 4 * (8256 * 128 + 128 * (8256 * 64 + 2 * 128 * 128 * 64)))  # 8 chunks of 128
    attn = 2 * T * (4096 * 32 * 128 * 2 + 4096 * 8 * 128 * 2) + 4 * 4 * 32 * 128 * 524800
    moe = 2 * T * (10 * 3 * 4096 * 768 + 4096 * 72 + 3 * 4096 * 1536)
    want = 18 * (mamba + ssd) + 2 * attn + 20 * moe + 2 * T * 4096 * 100352
    got = counts.model_flops(GRANITE_CUT, 4, 1024)["total"]
    assert got == pytest.approx(want, rel=1e-12)
    assert got == pytest.approx(3.819e13, rel=1e-3)
    # without a width of its own the shared expert takes the experts'
    plain = dict(GRANITE_CUT, shared_expert_d_ff=0)
    less = 20 * 2 * T * 3 * 4096 * (1536 - 768)
    assert counts.model_flops(plain, 4, 1024)["total"] == pytest.approx(want - less, rel=1e-12)


def _traced(m, kernels):
    return {"model": m, "batch": 4, "seq": 1024,
            "trace": {"kernels": {k: {"seconds": 1e-3 * n, "count": n} for k, n in kernels}}}


@pytest.mark.parametrize("m,reads", [
    (lambda: manifest.config("olmoe-1b-7b")["model"], {"flash_attention_roofline"}),
    (lambda: manifest.config("mamba2-780m")["model"], {"ssd_scan_roofline"}),
    (lambda: GRANITE_CUT, {"flash_attention_roofline", "ssd_scan_roofline"}),
    (lambda: JAMBA, {"flash_attention_roofline", "ssd_scan_roofline"}),
], ids=["attention", "ssm", "granite_cut", "jamba_pattern"])
def test_rooflines_read_where_the_layers_hold_their_kernel(m, reads):
    m = m()
    ctx = _traced(m, [("void tc::flash_fwd_bf16_kernel<128>", 96),
                      ("void tc::ssd_chunk_cb_kernel<float>", 96),
                      ("void tc::ssd_chunk_state_kernel<float>", 96),
                      ("void tc::ssd_state_pass_kernel<float>", 96),
                      ("void tc::ssd_chunk_scan_kernel<float>", 96)])
    for name in ("flash_attention_roofline", "ssd_scan_roofline"):
        got = manifest.reader(name).read(ctx)
        assert (got is not None) == (name in reads), name
        if got is not None:
            assert 0 < got < 100
