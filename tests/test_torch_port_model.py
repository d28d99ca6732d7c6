"""Log-mel, FpNetwork and Embedder of the port against the JAX package.

Tolerances:
  * f32: rtol=1e-4, atol=2e-5 on unit-norm embeddings — what
    tests/test_torch_parity.py holds this network to; XLA and torch sum
    the convs and LayerNorm statistics in different orders on the CPU.
  * bf16: atol=2e-2 on unit-norm embeddings.  Both packages cast each conv
    input and weight to bf16 and keep LayerNorm in f32, but they round the
    conv sums (and conv + bias) at different points, each worth up to one
    bf16 ulp (2^-8) per layer through 8 blocks.
  * log-mel: atol=2e-3 on log-energies (|x| up to ~20): the DFT matmuls
    sum 1024 products in a different order, and log(p + 1e-8) amplifies
    the relative error of the smallest bins.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pfann_tpu.index.embedder import Embedder as JaxEmbedder
from pfann_tpu.models.fp_network import build_fp_network as jax_build
from pfann_tpu.ops.melspec import MelSpec as JaxMelSpec
from pfann_tpu.utils import checkpoint as jckpt
from pfann_tpu_torch.index.embedder import Embedder as TorchEmbedder
from pfann_tpu_torch.models.fp_network import build_fp_network as torch_build
from pfann_tpu_torch.ops.melspec import MelSpec as TorchMelSpec
from pfann_tpu_torch.utils.checkpoint import params_from_flax

F32 = dict(rtol=1e-4, atol=2e-5)
BF16_ATOL = 2e-2
MEL_ATOL = 2e-3

CFG = {
    "sample_rate": 8000, "stft_n": 1024, "stft_hop": 256, "n_mels": 256,
    "f_min": 300, "f_max": 4000, "segment_size": 1, "hop_size": 0.5,
    "indexer": {"top_k": 10, "frame_shift_mul": 1},
}
# T goes 32 -> 16 -> 8 -> 8 -> 4 -> 4 -> 2 -> 2 -> 1 (three unit T strides)
STRIDES = [[[1, s], [2, 1]] for s in (2, 2, 1, 2, 1, 2, 1, 2)]


@pytest.mark.parametrize("naf_mode", [False, True])
def test_melspec_matches_jax(naf_mode):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 8000)) * 0.3).astype(np.float32)
    kw = dict(naf_mode=naf_mode, mel_log="log10" if naf_mode else "log",
              spec_norm="max" if naf_mode else "l2")
    want = np.asarray(JaxMelSpec(impl="dft", **kw)(jnp.asarray(x)))
    got = TorchMelSpec(**kw)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 256, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=MEL_ATOL)


def _models(model_cfg, seed=0):
    cfg = dict(CFG, model=model_cfg)
    jm = jax_build(cfg, compute_dtype=jnp.float32)
    variables = jax.jit(jm.init)(jax.random.key(seed), jnp.zeros((1, 256, 32)))
    sd = params_from_flax(jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                                       variables))
    return cfg, variables, sd


def _forward_pair(cfg, variables, sd, x, jdtype, tdtype):
    jm = jax_build(cfg, compute_dtype=jdtype)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    tm = torch_build(cfg, compute_dtype=tdtype)
    tm.load_state_dict(sd)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    return got, want


MODEL_VARIANTS = {
    "fuller": {"d": 8, "h": 32, "u": 4, "fuller": True},
    "depthwise": {"d": 8, "h": 32, "u": 4, "fuller": False},
    "elu": {"d": 8, "h": 32, "u": 4, "fuller": True, "conv_activation": "ELU"},
    "strides": {"d": 8, "h": 32, "u": 4, "fuller": False, "strides": STRIDES},
    "norm_after_act": {"d": 8, "h": 32, "u": 4, "fuller": True,
                       "relu_after_bn": False},
}


@pytest.mark.parametrize("variant", sorted(MODEL_VARIANTS))
def test_fp_network_f32_matches_jax(variant):
    cfg, variables, sd = _models(MODEL_VARIANTS[variant])
    x = np.random.default_rng(1).standard_normal((4, 256, 32)).astype(np.float32)
    got, want = _forward_pair(cfg, variables, sd, x, jnp.float32, torch.float32)
    assert got.shape == (4, 8) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("variant", ["fuller", "depthwise"])
def test_fp_network_bf16_matches_jax(variant):
    cfg, variables, sd = _models(MODEL_VARIANTS[variant])
    x = np.random.default_rng(2).standard_normal((4, 256, 32)).astype(np.float32)
    got, want = _forward_pair(cfg, variables, sd, x, jnp.bfloat16, torch.bfloat16)
    assert got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    cfg, variables, _ = _models({"d": 16, "h": 64, "u": 8, "fuller": True}, seed=4)
    path = str(tmp_path_factory.mktemp("model") / "model.msgpack")
    jckpt.save_model(path, variables)
    return cfg, path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_songs_matches_jax(model_file, dtype):
    """Embedder.embed_songs (device unfold + de-mean + mel + model) on the
    same int16 and f32 signals through both packages; Embedder.embed on
    host-unfolded segments agrees too."""
    cfg, path = model_file
    rng = np.random.default_rng(9)
    hop = 4000
    sig_i16 = [(rng.standard_normal(n) * 6000).astype(np.int16)
               for n in (8000, 20000, 13000)]
    sig_f32 = [(rng.standard_normal(n) * 0.2).astype(np.float32) for n in (9000, 16000)]
    counts_i16 = [(s.shape[0] - 8000) // hop + 1 for s in sig_i16]
    counts_f32 = [(s.shape[0] - 8000) // hop + 1 for s in sig_f32]

    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    je = JaxEmbedder(cfg, path, compute_dtype=jdt, chunk=64)
    te = TorchEmbedder(cfg, path, "cpu", compute_dtype=tdt, chunk=64)
    tol = dict(rtol=0, atol=BF16_ATOL) if dtype == "bfloat16" else F32
    for sigs, counts in ((sig_i16, counts_i16), (sig_f32, counts_f32)):
        want = je.embed_songs(sigs, counts, hop)
        got = te.embed_songs(sigs, counts, hop)
        assert [g.shape for g in got] == [w.shape for w in want] == [
            (c, 16) for c in counts]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **tol)

    segs = np.stack([sig_f32[1][i * hop : i * hop + 8000] for i in range(3)])
    segs = segs - segs.mean(axis=1, keepdims=True)
    np.testing.assert_allclose(te.embed(segs), je.embed(segs), **tol)
