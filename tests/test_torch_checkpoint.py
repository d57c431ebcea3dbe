"""The port's checkpoints, token pipeline and training loop against the JAX
package's: the MessagePack bytes, checkpoints that cross both ways bit for
bit (fp32, bf16 and the int32 step), corruption, retention and
partial-write invisibility (as tests/test_checkpoint.py), the resumed
training loop, and the pipeline's batches."""
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.manager import CheckpointManager as JaxCheckpointManager  # noqa: E402
from repro.data.pipeline import DataConfig as JaxDataConfig  # noqa: E402
from repro.data.pipeline import TokenPipeline as JaxTokenPipeline  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint import manager as port_manager  # noqa: E402
from repro_torch.checkpoint import msgpack_subset  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402


def _np_state(seed=0):
    """A train-state-shaped tree as numpy (bf16 as ml_dtypes), the JAX
    layout: params, opt/m, opt/v, opt/step."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((8, 8)).astype(np.float32)
    return {
        "params": {"layers": {"sub0": {"mixer": {"wq": w}}},
                   "b": np.asarray(jnp.asarray(rng.standard_normal(8), jnp.bfloat16))},
        "opt": {"m": {"layers": {"sub0": {"mixer": {"wq": w * 0.5}}},
                      "b": rng.standard_normal(8).astype(np.float32)},
                "v": {"layers": {"sub0": {"mixer": {"wq": w * w}}},
                      "b": np.abs(rng.standard_normal(8)).astype(np.float32)},
                "step": np.asarray(7, np.int32)},
    }


def _jax_state(seed=0):
    return jax.tree_util.tree_map(jnp.asarray, _np_state(seed))


def _torch_state(seed=0):
    return params_from_numpy(_np_state(seed), "cpu")


def _bits(x):
    """The raw bytes of a leaf (bf16 as its 16-bit words)."""
    if torch.is_tensor(x):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


def _assert_bit_equal(got, want):
    g, w = dict(T.items(got)), dict(T.items(want))
    assert sorted(g) == sorted(w)
    for k in w:
        assert _bits(g[k]) == _bits(w[k]), k


# ---------------------------------------------------------------------------
# MessagePack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("obj", [
    {"codec": "zstd", "meta": {"a/b": {"shape": [8, 8], "dtype": "float32",
                                       "sha256": "0123456789abcdef", "bytes": 256}},
     "data": {"a/b": b"\x00\x01\xff"}},
    [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63 - 1],
    [-1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63],
    ["", "x" * 31, "y" * 32, "z" * 255, "w" * 256, "v" * 65536, "ünï"],
    [b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 65536],
    {f"k{i}": i for i in range(16)},
    {f"k{i}": [i] * 16 for i in range(3)},
    [list(range(15)), list(range(16)), list(range(70000))],
    {},
    [],
], ids=["shard", "uints", "negints", "str", "bin", "map16", "array16", "arrays", "emptymap",
        "emptyarray"])
def test_msgpack_subset_bytes_equal_msgpack(obj):
    blob = msgpack_subset.packb(obj)
    assert blob == msgpack.packb(obj, use_bin_type=True)
    assert msgpack.unpackb(blob, raw=False) == obj
    assert msgpack_subset.unpackb(blob) == obj


def test_msgpack_subset_refuses_what_the_format_does_not_use():
    for bad in (1.5, None, True):
        with pytest.raises(TypeError):
            msgpack_subset.packb({"x": bad})
    with pytest.raises(ValueError):
        msgpack_subset.unpackb(msgpack.packb(1.5))


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------


def test_port_saves_and_jax_restores_bit_equal(tmp_path):
    state = _torch_state()
    CheckpointManager(tmp_path, keep=2).save(3, state)
    like = jax.tree_util.tree_map(jnp.zeros_like, _jax_state(1))
    step, restored = JaxCheckpointManager(tmp_path, keep=2).restore_latest(like)
    assert step == 3
    _assert_bit_equal(restored, state)
    assert restored["params"]["b"].dtype == jnp.bfloat16
    assert restored["opt"]["step"].dtype == jnp.int32


def test_jax_saves_and_port_restores_bit_equal(tmp_path):
    state = _jax_state()
    JaxCheckpointManager(tmp_path, keep=2).save(4, state, extra={"loss": 1.5})
    like = T.tree_map(torch.zeros_like, _torch_state(1))
    step, restored = CheckpointManager(tmp_path, keep=2).restore_latest(like)
    assert step == 4
    _assert_bit_equal(restored, state)
    assert restored["params"]["b"].dtype == torch.bfloat16
    assert restored["opt"]["step"].dtype == torch.int32


def test_port_shards_equal_jax_shards(tmp_path):
    """The same state written by both managers as host 1 of 2: byte-equal
    shard files (one codec on both sides)."""
    JaxCheckpointManager(tmp_path / "j").save(2, _jax_state(), host_id=1, num_hosts=2)
    CheckpointManager(tmp_path / "p").save(2, _torch_state(), host_id=1, num_hosts=2)
    name = "step_0000000002.tmp/shard_00001.msgpack.zst"
    assert (tmp_path / "j" / name).read_bytes() == (tmp_path / "p" / name).read_bytes()


def test_multi_host_shards_restore_across_packages(tmp_path):
    jm, pm = JaxCheckpointManager(tmp_path), CheckpointManager(tmp_path)
    pm.save(5, _torch_state(), host_id=1, num_hosts=2)  # the port writes host 1's shard
    jm.save(5, _jax_state(), host_id=0, num_hosts=2)    # JAX commits as host 0
    step, restored = pm.restore_latest(T.tree_map(torch.zeros_like, _torch_state(1)))
    assert step == 5
    _assert_bit_equal(restored, _torch_state())


def test_restore_puts_leaves_on_like_dtype_and_device(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _torch_state())
    like = T.tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float64), _torch_state())
    restored = mgr.restore(1, like)
    assert all(t.dtype == torch.float64 for t in T.leaves(restored))
    np.testing.assert_array_equal(restored["params"]["layers"]["sub0"]["mixer"]["wq"].numpy(),
                                  _np_state()["params"]["layers"]["sub0"]["mixer"]["wq"])


def test_zlib_codec_crosses_too(tmp_path, monkeypatch):
    """Where ``zstandard`` is missing the port writes zlib and names it; the
    JAX manager reads that codec name too."""
    monkeypatch.setattr(port_manager, "zstd", None)
    path = CheckpointManager(tmp_path).save(1, _torch_state())
    blob = msgpack.unpackb(next(path.glob("shard_*")).read_bytes(), raw=False)
    assert blob["codec"] == "zlib"
    like = jax.tree_util.tree_map(jnp.zeros_like, _jax_state(1))
    _assert_bit_equal(JaxCheckpointManager(tmp_path).restore(1, like), _torch_state())


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py's cases on the port
# ---------------------------------------------------------------------------


def test_corruption_detected(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    path = mgr.save(1, _torch_state())
    shard = next(path.glob("shard_*.zst"))
    blob = bytearray(shard.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    shard.write_bytes(bytes(blob))
    with pytest.raises(Exception):
        mgr.restore(1, _torch_state(1))


def test_checksum_mismatch_names_the_shard(tmp_path):
    """A payload that decompresses but to other bytes fails its sha256."""
    mgr = CheckpointManager(tmp_path)
    path = mgr.save(1, _torch_state())
    shard = next(path.glob("shard_*.zst"))
    blob = msgpack_subset.unpackb(shard.read_bytes())
    key = "opt/step"
    blob["data"][key] = port_manager._compressor(3).compress(np.int32(8).tobytes())
    shard.write_bytes(msgpack_subset.packb(blob))
    with pytest.raises(IOError, match="checksum mismatch.*opt/step"):
        mgr.restore(1, _torch_state(1))


def test_retention_keeps_newest_and_milestones(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for step in (1, 2, 3, 4, 5):
        mgr.save(step, _torch_state())
    assert mgr.steps() == [4, 5]
    mgr = CheckpointManager(tmp_path / "m", keep=1, milestone_every=2)
    for step in (1, 2, 3, 4, 5):
        mgr.save(step, _torch_state())
    assert mgr.steps() == [2, 4, 5]


def test_partial_write_is_invisible(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save(7, _torch_state())
    crash = mgr.dir / "step_0000000009.tmp"
    crash.mkdir()
    (crash / "shard_00000.msgpack.zst").write_bytes(b"junk")
    assert mgr.steps() == [7]
    assert mgr.latest_step() == 7
    assert mgr.restore_latest(_torch_state(1))[0] == 7


def test_deterministic_resume_training(tmp_path, capsys):
    """A crash + restart of the port's train_loop on the CPU reproduces the
    uninterrupted run (same LR horizon, same data stream, checkpoint
    roundtrip bit-exact)."""
    from repro_torch.launch.train import train_loop

    kw = dict(steps=8, ckpt_every=4, global_batch=2, seq_len=16, log_every=100,
              device="cpu")
    _, losses_full, _ = train_loop("qwen2.5-3b", ckpt_dir=str(tmp_path / "a"), **kw)
    with pytest.raises(RuntimeError, match="injected failure at step 5"):
        train_loop("qwen2.5-3b", ckpt_dir=str(tmp_path / "b"), fail_at_step=5, **kw)
    _, losses_resumed, _ = train_loop("qwen2.5-3b", ckpt_dir=str(tmp_path / "b"), **kw)
    assert "resumed from step 4" in capsys.readouterr().out
    assert len(losses_resumed) == 4
    np.testing.assert_allclose(losses_full[-4:], losses_resumed, rtol=1e-4)


def test_train_example_runs_tiny_on_the_cpu(tmp_path):
    """examples/torch_train_lm.py --tiny, as examples/train_lm.py --tiny."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "torch_train_lm.py"
    spec = importlib.util.spec_from_file_location("torch_train_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    losses = mod.main(["--tiny", "--device", "cpu", "--steps", "3",
                       "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert CheckpointManager(tmp_path).steps() == [3]


def test_train_main_defaults_to_the_card():
    from repro_torch.launch.train import main

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--steps", "1"])


# ---------------------------------------------------------------------------
# the token pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step,host,hosts", [(0, 0, 0, 1), (3, 17, 1, 2), (7, 5, 3, 4)])
def test_pipeline_batches_equal_jax(seed, step, host, hosts):
    cfg = dict(vocab_size=256, global_batch=8, seq_len=24, seed=seed)
    got = TokenPipeline(DataConfig(**cfg)).batch_at(step, host_id=host, num_hosts=hosts)
    want = JaxTokenPipeline(JaxDataConfig(**cfg)).batch_at(step, host_id=host, num_hosts=hosts)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
    it = TokenPipeline(DataConfig(**cfg)).iterate(step, host_id=host, num_hosts=hosts)
    np.testing.assert_array_equal(next(it)["tokens"], got["tokens"])
