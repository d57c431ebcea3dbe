"""A configuration enters the benchmark by its own files: a third, hybrid
configuration (Mamba2 and attention mixers, experts beside a shared expert
of a width of its own) put into a copy of the benchmark, with no file but
its own and ``BENCHMARK.json`` changed, passes the manifest's checks there:
the contract, its published widths, its FLOPs layer by layer, and every
metric of its cell read from a context of its own."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
NAME = "granite-cut"
CELL = f"{NAME}.saturate"

DOC = {
    "name": NAME,
    "source": "https://huggingface.co/ibm-granite/granite-4.0-h-small/blob/main/config.json",
    "hidden_size": 4096, "num_hidden_layers": 20, "num_attention_heads": 32,
    "num_key_value_heads": 8, "intermediate_size": 768, "shared_intermediate_size": 1536,
    "num_local_experts": 72, "num_experts_per_tok": 10, "mamba_d_state": 128,
    "mamba_d_head": 64, "mamba_expand": 2, "vocab_size": 100352,
    "reduced": ["num_hidden_layers", "num_layers"],
    "published": {"d_model": 4096, "num_layers": 40, "num_heads": 32, "num_kv_heads": 8,
                  "head_dim": 128, "expert_d_ff": 768, "shared_expert_d_ff": 1536,
                  "num_experts": 72, "experts_per_token": 10, "ssm_state": 128,
                  "ssm_headdim": 64, "ssm_expand": 2, "vocab_size": 100352},
    "model": {"name": NAME, "family": "hybrid", "num_layers": 20, "d_model": 4096,
              "num_heads": 32, "num_kv_heads": 8, "head_dim": 128, "d_ff": 768,
              "expert_d_ff": 768, "shared_expert_d_ff": 1536, "moe_shared_expert": True,
              "vocab_size": 100352, "num_experts": 72, "experts_per_token": 10,
              "moe_every": 1, "attn_every": 10, "ssm_state": 128, "ssm_headdim": 64,
              "ssm_expand": 2, "ssm_conv": 4, "ssm_chunk": 128, "param_dtype": "bfloat16",
              "compute_dtype": "bfloat16"},
    "check": {"logit_gap": 0.5},
}
REFERENCE = '''"""A stand-in reference: the manifest's checks ask only that it is there."""


def layout(m):
    return []


def forward_last(W, tokens, m, precision="fp32"):
    raise NotImplementedError
'''


def _add(bench: dict) -> dict:
    bench["configs"].append({"name": NAME, "source": DOC["source"],
                             "file": f"sagebench/configs/{NAME}.json",
                             "reduced": DOC["reduced"],
                             "why": "two of four periods of a hybrid: Mamba2 and GQA mixers, "
                                    "72 experts top-10 beside a shared expert"})
    bench["workloads"].append({"name": CELL, "config": NAME, "traffic": "closed_8", "chips": 1,
                               "why": "4 x 1024 tokens, 8 closed-loop clients, one warm node"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and m.get("moves", m["name"]) == "invocations_per_s":
            m["workloads"].append(CELL)
    bench["per_layer"].append({"name": "flash_attention_roofline.saturate", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "kernels", "moves": "invocations_per_s",
                               "workloads": [CELL]})
    return bench


def _files(root: Path) -> dict:
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_third_configuration_needs_only_its_own_files(tmp_path):
    shutil.copytree(HERE, tmp_path / "sagebench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = _add(json.loads((ROOT / "BENCHMARK.json").read_text()))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    configs = tmp_path / "sagebench" / "configs"
    (configs / f"{NAME}.json").write_text(json.dumps(DOC, indent=1))
    (configs / f"{NAME}.py").write_text(REFERENCE)
    # nothing of the benchmark's own files changed but the manifest
    before, after = _files(HERE), _files(tmp_path / "sagebench")
    changed = {p for p in after if before.get(p) != after[p]}
    assert changed == {Path("configs") / f"{NAME}.json", Path("configs") / f"{NAME}.py"}
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-rA", "-p", "no:cacheprovider",
         "sagebench/tests/test_sagebench_manifest.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=300, env={"PATH": os.environ.get("PATH", "/usr/bin:/bin")})
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-2000:]
    passed = [ln for ln in res.stdout.splitlines() if ln.startswith("PASSED")]
    for test in ("test_configurations_keep_published_widths",
                 "test_every_configuration_is_counted_layer_by_layer"):
        assert any(f"{test}[{NAME}]" in ln for ln in passed), test
    assert any(f"test_every_metric_of_a_cell_reads_its_context[{CELL}]" in ln for ln in passed)
