"""The port's model.msgpack reader/writer and weight bridge against flax.

The port reads and writes flax's msgpack format with no flax and no
msgpack package; these tests hold it to ``flax.serialization`` bit for bit.
"""

import numpy as np
import pytest
import torch

import flax.serialization
import jax
import jax.numpy as jnp

from pfann_tpu.models.fp_network import build_fp_network as jax_build
from pfann_tpu_torch.models.fp_network import build_fp_network as torch_build
from pfann_tpu_torch.utils import checkpoint as tckpt

CFG = {
    "sample_rate": 8000, "stft_n": 1024, "stft_hop": 256, "n_mels": 256,
    "f_min": 300, "f_max": 4000, "segment_size": 1, "hop_size": 0.5,
}


def _tree(rng):
    """A flax-like tree with f32, bf16, int and odd-sized leaves (every
    msgpack length form the writer can meet: fixstr/str8 keys, fixmap,
    bin8/bin16/bin32 payloads, fixext and ext8/16/32 headers)."""
    return {
        "params": {
            "a": rng.standard_normal((3, 4)).astype(np.float32),
            "bf": np.asarray(
                jnp.asarray(rng.standard_normal((5, 7)), jnp.bfloat16)),
            "big": rng.standard_normal((70_000,)).astype(np.float32),
            "mid": rng.standard_normal((300,)).astype(np.float32),
            "i32": np.arange(6, dtype=np.int32).reshape(2, 3),
            "scalar": np.ones((), np.float32),
            "empty": np.zeros((0, 3), np.float32),
            "long_key_name_past_thirty_one_chars_x": np.ones((1,), np.float32),
            "nested": {str(i): np.full((i + 1,), i, np.float32) for i in range(17)},
        }
    }


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + "/" + k)
    else:
        yield prefix, tree


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().tobytes(), "bfloat16", tuple(x.shape)
        return x.numpy().tobytes(), str(x.dtype).split(".")[1], tuple(x.shape)
    x = np.asarray(x)
    return x.tobytes(), x.dtype.name, x.shape


def test_reader_matches_flax_bit_exact():
    """flax.to_bytes -> the port's reader: every leaf bit-identical, with
    its dtype (f32 and bf16) and shape."""
    tree = _tree(np.random.default_rng(0))
    got = tckpt.msgpack_restore(flax.serialization.to_bytes(tree))
    want = dict(_leaves(tree))
    have = dict(_leaves(got))
    assert have.keys() == want.keys()
    for k in want:
        assert _bits(have[k]) == _bits(want[k]), k


def test_writer_read_by_flax_and_byte_equal():
    """The port's writer: flax.from_bytes restores it leaf for leaf, and
    the bytes equal flax.to_bytes of the same tree."""
    tree = _tree(np.random.default_rng(1))
    data = tckpt.msgpack_serialize(tree)
    assert data == flax.serialization.to_bytes(tree)
    back = flax.serialization.msgpack_restore(data)
    for (k, v), (k2, v2) in zip(_leaves(tree), _leaves(back)):
        assert k == k2 and _bits(v) == _bits(v2), k


def test_roundtrip_torch_tensors_f32_bf16():
    """Tensors written by the port (f32 and bf16) read back bit-exact by
    the port and by flax."""
    g = torch.Generator().manual_seed(0)
    tree = {"x": torch.randn(4, 5, generator=g),
            "y": torch.randn(3, 2, generator=g).to(torch.bfloat16)}
    data = tckpt.msgpack_serialize(tree)
    back = tckpt.msgpack_restore(data)
    for k in tree:
        assert back[k].dtype == tree[k].dtype
        assert _bits(back[k]) == _bits(tree[k])
    fl = flax.serialization.msgpack_restore(data)
    assert np.asarray(fl["y"]).dtype == jnp.bfloat16
    assert fl["y"].view(np.int16).tobytes() == _bits(tree["y"])[0]
    np.testing.assert_array_equal(fl["x"], tree["x"].numpy())


@pytest.mark.parametrize("fuller", [True, False])
def test_weight_bridge_roundtrip(tmp_path, fuller):
    """JAX init -> flax model.msgpack -> port state dict loads strictly
    into the port's FpNetwork (conv HWIO->OIHW, depthwise I=1, LN
    (F,T,C)->(C,F,T)); save_model writes a file the JAX loader restores to
    the identical tree."""
    from pfann_tpu.utils import checkpoint as jckpt

    cfg = dict(CFG, model={"d": 8, "h": 32, "u": 4, "fuller": fuller})
    jmodel = jax_build(cfg)
    variables = jax.jit(jmodel.init)(jax.random.key(3), jnp.zeros((1, 256, 32)))
    path = str(tmp_path / "model.msgpack")
    jckpt.save_model(path, variables)

    sd = tckpt.load_model(path)
    tmodel = torch_build(cfg)
    tmodel.load_state_dict(sd)  # strict: every key and shape matches
    conv2 = sd["f.block0.conv2.weight"]
    assert conv2.shape == (8, 8 if fuller else 1, 3, 1)
    assert sd["f.block0.ln1.weight"].shape == (8, 256, 16)

    out = str(tmp_path / "model2.msgpack")
    tckpt.save_model(out, tmodel.state_dict())
    back = jckpt.load_model(out, variables)
    for (k, v), (k2, v2) in zip(
        jax.tree_util.tree_leaves_with_path(variables),
        jax.tree_util.tree_leaves_with_path(back),
    ):
        assert k == k2
        np.testing.assert_array_equal(np.asarray(v), np.asarray(v2))


@pytest.mark.parametrize("fuller", [True, False])
def test_save_model_bytes_equal_jax_save_model(tmp_path, fuller):
    """The port's save_model writes the bytes the JAX package's save_model
    writes for the same weights (its keys sorted, as jax.tree.map leaves
    them), so tools converting a model give byte-equal files."""
    from pfann_tpu.utils import checkpoint as jckpt

    cfg = dict(CFG, model={"d": 8, "h": 32, "u": 4, "fuller": fuller})
    variables = jax.jit(jax_build(cfg).init)(jax.random.key(5), jnp.zeros((1, 256, 32)))
    path, out = str(tmp_path / "jax.msgpack"), str(tmp_path / "port.msgpack")
    jckpt.save_model(path, variables)
    tckpt.save_model(out, tckpt.load_model(path))
    with open(path, "rb") as f, open(out, "rb") as g:
        assert g.read() == f.read()
