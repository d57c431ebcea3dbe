"""The port's decode path: ``init_cache`` / ``prefill`` / ``decode_step``
and the serving step factories, against the port's own full forward (the
analog of tests/test_models.py::test_decode_matches_forward) and against
the JAX package's ``prefill`` / ``decode_step`` on the same weights
(carried over through numpy) and tokens, for every family with a decode
path: dense, Mamba2, MoE, hybrid, M-RoPE and encoder-decoder."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.serving import cache_shapes as jax_cache_shapes  # noqa: E402
from repro.serving import greedy_sample as jax_greedy_sample  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.models import decode_step, forward, init_cache, init_params, prefill  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    cache_shapes, greedy_sample, make_decode_step, make_prefill_step,
)

ZOO = ["olmoe-1b-7b", "llama4-maverick-400b-a17b", "jamba-1.5-large-398b",
       "whisper-small", "qwen2-vl-72b"]
ARCHS_DECODE = ["qwen2.5-3b", "qwen3-8b", "mamba2-780m"] + ZOO
B, S, SP = 2, 24, 16  # tests/test_models.py: batch, full length, prompt length
ENC = 12  # encoder frames of the whisper cases (tests/test_models.py)


def _tokens(cfg, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S), dtype=np.int32)


def _enc_len(cfg):
    return ENC if cfg.is_encoder_decoder else 0


def _extra(cfg, seed=3):
    """The batch entries besides the tokens: whisper's encoder embeddings."""
    if not cfg.is_encoder_decoder:
        return {}
    rng = np.random.default_rng(seed)
    return {"encoder_embeds": rng.standard_normal((B, ENC, cfg.d_model), dtype=np.float32)}


def _torch_batch(tokens, extra):
    return {"tokens": torch.from_numpy(tokens),
            **{k: torch.from_numpy(v) for k, v in extra.items()}}


def _jax_batch(tokens, extra):
    return {"tokens": jnp.asarray(tokens), **{k: jnp.asarray(v) for k, v in extra.items()}}


@pytest.mark.parametrize("arch", ARCHS_DECODE)
def test_decode_matches_forward(arch):
    """prefill + token-by-token decode reproduces the full-sequence logits
    (tests/test_models.py's property and tolerances, 2e-3 / 1e-3)."""
    cfg = ARCHS[arch].reduced()
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=8.0)  # drop-free
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    toks = torch.from_numpy(_tokens(cfg))
    extra = {k: torch.from_numpy(v) for k, v in _extra(cfg).items()}
    full, _ = forward(cfg, params, {"tokens": toks, **extra})
    cache = init_cache(cfg, B, S + 4, _enc_len(cfg), device="cpu")
    lg, cache2, _ = prefill(cfg, params, {"tokens": toks[:, :SP], **extra}, cache)
    assert cache2 is cache  # filled in place
    np.testing.assert_allclose(lg.numpy(), full[:, SP - 1].numpy(), atol=2e-3, rtol=1e-3)
    before = dec.launches
    for t in range(SP, S):
        lg, cache = decode_step(cfg, params, toks[:, t:t + 1],
                                torch.full((B,), t, dtype=torch.int32), cache)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(), atol=2e-3, rtol=1e-3)
    assert dec.launches == before  # CPU tensors never reach the CUDA kernel


@pytest.mark.parametrize("arch", ARCHS_DECODE)
def test_serving_steps_match_jax(arch):
    """The port's prefill and decode steps give the JAX package's logits on
    the same weights and tokens, with greedy sampling fed back (the sampled
    tokens agree too). MoE configs keep their capacity factor: the
    prefill's drops are the reference's."""
    _serving_steps_match_jax(arch)


def test_whisper_serving_with_a_deeper_encoder_matches_jax():
    """As above with 3 encoder layers against 2 decoder periods."""
    _serving_steps_match_jax("whisper-small", encoder_layers=3)


def _serving_steps_match_jax(arch, **overrides):
    ref_cfg, cfg = REF_ARCHS[arch].reduced(**overrides), ARCHS[arch].reduced(**overrides)
    jparams = jax_init_params(ref_cfg, jax.random.PRNGKey(1))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    prompt, extra = _tokens(cfg)[:, :SP], _extra(cfg)
    jlg, jcache, _ = jax_prefill(ref_cfg, jparams, _jax_batch(prompt, extra),
                                 jax_init_cache(ref_cfg, B, S, _enc_len(cfg)))
    prefill_step, decode = make_prefill_step(cfg), make_decode_step(cfg)
    lg, cache = prefill_step(params, _torch_batch(prompt, extra),
                             init_cache(cfg, B, S, _enc_len(cfg), device="cpu"))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=2e-3, rtol=1e-3)
    for t in range(SP, S):
        nxt, jnxt = greedy_sample(lg), jax_greedy_sample(jlg)
        assert nxt.dtype == torch.int32
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
        lg, cache = decode(params, nxt[:, None], torch.full((B,), t, dtype=torch.int32),
                           cache)
        jlg, jcache = jax_decode_step(ref_cfg, jparams, jnxt[:, None],
                                      jnp.full((B,), t, jnp.int32), jcache)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=2e-3, rtol=1e-3)
    assert set(cache) == set(jcache)
    for key, entry in cache.items():  # the caches agree as well
        assert set(entry) == set(jcache[key])
        for name, leaf in entry.items():
            np.testing.assert_allclose(leaf.float().numpy(),
                                       np.asarray(jcache[key][name], np.float32),
                                       atol=2e-3, rtol=1e-3)


def test_cross_cache_of_another_length_raises():
    """The port fills the cross cache in place, so it must hold the
    encoder's length (the JAX prefill would replace it)."""
    cfg = ARCHS["whisper-small"].reduced()
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    batch = _torch_batch(_tokens(cfg)[:, :SP], _extra(cfg))
    with pytest.raises(ValueError, match=f"enc_len={ENC}"):
        prefill(cfg, params, batch, init_cache(cfg, B, S, ENC + 1, device="cpu"))


@pytest.mark.parametrize("arch", ARCHS_DECODE)
@pytest.mark.parametrize("reduced", [True, False])
def test_cache_shapes_match_jax(arch, reduced):
    """``cache_shapes`` allocates nothing (meta tensors) and has the JAX
    package's keys, shapes and dtypes, at the full-width serving size too
    (whisper: its cross cache at the encoder's length)."""
    cfg, ref_cfg = ARCHS[arch], REF_ARCHS[arch]
    if reduced:
        cfg, ref_cfg = cfg.reduced(), ref_cfg.reduced()
    batch, max_len = (2, 28) if reduced else (4, 1056)
    enc_len = (ENC if reduced else 1500) if cfg.is_encoder_decoder else 0  # 30 s of audio
    got = cache_shapes(cfg, batch, max_len, enc_len)
    want = jax_cache_shapes(ref_cfg, batch, max_len, enc_len)
    assert set(got) == set(want)
    for key, entry in got.items():
        assert set(entry) == set(want[key])
        for name, leaf in entry.items():
            assert leaf.is_meta
            assert tuple(leaf.shape) == tuple(want[key][name].shape)
            assert str(leaf.dtype).replace("torch.", "") == str(want[key][name].dtype)


def test_greedy_sample_is_int32_argmax():
    logits = np.random.default_rng(0).standard_normal((3, 50), dtype=np.float32)
    got = greedy_sample(torch.from_numpy(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_greedy_sample(jnp.asarray(logits))))


def _ref_and_port_params(arch, seed=1):
    ref_cfg, cfg = REF_ARCHS[arch].reduced(), ARCHS[arch].reduced()
    jparams = jax_init_params(ref_cfg, jax.random.PRNGKey(seed))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return ref_cfg, cfg, jparams, params


@pytest.mark.parametrize("prompt_len", [1, 2, 3, 4])
def test_short_mamba_prefill_raises_or_matches_jax(prompt_len):
    """A Mamba2 prefill shorter than the conv state (ssm_conv - 1 rows)
    raises ValueError in the port; the JAX package stores the short tail
    and its next decode step raises. From ssm_conv - 1 tokens on, the conv
    cache and the next decode step's logits agree within 1e-4."""
    ref_cfg, cfg, jparams, params = _ref_and_port_params("mamba2-780m")
    W1 = cfg.ssm_conv - 1
    assert W1 == 3
    prompt = _tokens(cfg)[:, :prompt_len]
    nxt = _tokens(cfg, seed=5)[:, :1]
    pos = np.full((B,), prompt_len, np.int32)
    cache = init_cache(cfg, B, 8, device="cpu")
    jcache = jax_init_cache(ref_cfg, B, 8)
    if prompt_len < W1:
        with pytest.raises(ValueError, match=rf"{prompt_len} tokens.*{W1} rows"):
            prefill(cfg, params, {"tokens": torch.from_numpy(prompt)}, cache)
        with pytest.raises(ValueError):
            _, jcache, _ = jax_prefill(ref_cfg, jparams, {"tokens": jnp.asarray(prompt)},
                                       jcache)
            jax_decode_step(ref_cfg, jparams, jnp.asarray(nxt), jnp.asarray(pos), jcache)
        return
    _, cache, _ = prefill(cfg, params, {"tokens": torch.from_numpy(prompt)}, cache)
    _, jcache, _ = jax_prefill(ref_cfg, jparams, {"tokens": jnp.asarray(prompt)}, jcache)
    np.testing.assert_allclose(cache["sub0"]["conv"].float().numpy(),
                               np.asarray(jcache["sub0"]["conv"], np.float32), atol=1e-4)
    lg, _ = decode_step(cfg, params, torch.from_numpy(nxt), torch.from_numpy(pos), cache)
    jlg, _ = jax_decode_step(ref_cfg, jparams, jnp.asarray(nxt), jnp.asarray(pos), jcache)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4)


def test_decode_past_the_cache_drops_the_write():
    """decode_step at position L (cache full) drops its k/v write, as the
    JAX scatter does, and attends over the whole cache: the logits are the
    JAX package's within 3e-5 (fp32) and the cache is unchanged."""
    ref_cfg, cfg, jparams, params = _ref_and_port_params("qwen2.5-3b")
    max_len = 4
    prompt = _tokens(cfg)[:, :max_len]
    nxt = _tokens(cfg, seed=5)[:, :1]
    pos = np.full((B,), max_len, np.int32)
    _, cache, _ = prefill(cfg, params, {"tokens": torch.from_numpy(prompt)},
                          init_cache(cfg, B, max_len, device="cpu"))
    _, jcache, _ = jax_prefill(ref_cfg, jparams, {"tokens": jnp.asarray(prompt)},
                               jax_init_cache(ref_cfg, B, max_len))
    before = {k: {n: t.clone() for n, t in e.items()} for k, e in cache.items()}
    lg, cache = decode_step(cfg, params, torch.from_numpy(nxt), torch.from_numpy(pos), cache)
    jlg, _ = jax_decode_step(ref_cfg, jparams, jnp.asarray(nxt), jnp.asarray(pos), jcache)
    assert lg.shape == (B, cfg.vocab_size)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=3e-5)
    for key, entry in cache.items():
        for name, leaf in entry.items():
            assert torch.equal(leaf, before[key][name]), (key, name)
