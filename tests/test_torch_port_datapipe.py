"""The port's training data pipeline against the JAX package's, on the CPU.

Host parts are copies and must be bit-equal: the mock loader's and the
shuffler's batches, the music cache bytes, the crop cues and the gathered
int16 windows (the host gather and both device gathers).  The device
augmentation is tested by its math with JAX's own draws fed in:
  * add_noises, with and without band_power: rtol 1e-5, atol 1e-6 (f32
    RMS and FFT sums in other orders);
  * ir_convolve: atol 1e-5 on unit-scale signals (pocketfft and torch's
    FFT round differently);
  * log-mel batches (clean, and the whole augment chain): atol 2e-3 on
    log-energies, the tolerance tests/test_torch_port_model.py holds the
    log-mel to.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pfann_tpu.data import segments as jsegments
from pfann_tpu.data.mock import MockedDataLoader as JaxMock
from pfann_tpu.data.preprocess import ensure_music_cache as jax_ensure_cache
from pfann_tpu.data.shuffler import TwoStageShuffler as JaxShuffler
from pfann_tpu.data.shuffler import batched as jax_batched
from pfann_tpu.ops import augment as jaugment
from pfann_tpu_torch.data import segments
from pfann_tpu_torch.data.mock import MockedDataLoader
from pfann_tpu_torch.data.prefetch import prefetch
from pfann_tpu_torch.data.preprocess import ensure_music_cache
from pfann_tpu_torch.data.shuffler import TwoStageShuffler, batched
from pfann_tpu_torch.ops import augment

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEL_ATOL = 2e-3
MOCK = {"n_mels": 256, "segment_size": 1, "sample_rate": 8000, "stft_hop": 256,
        "batch_size": 10, "mock_sizes": [37, 12]}


@pytest.fixture(autouse=True)
def _few_threads(monkeypatch):
    """Two torch threads here and in child processes: the suite runs
    several workers on one machine, and torch's thread pools in each,
    spinning over all cores, slowed these tests tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    yield
    torch.set_num_threads(n)


def _cfg(pipeline_root, tmp_path, **kw):
    """pipeline_root with caches and model under tmp_path."""
    return dict(pipeline_root, cache_dir=str(tmp_path / "caches"),
                model_dir=str(tmp_path / "model"), **kw)


# ------------------------------------------------------------ host copies
@pytest.mark.parametrize("shuffle", [True, False])
def test_mock_loader_batches_equal_jax(shuffle):
    for split in ("train", "validate"):
        got, want = MockedDataLoader(split, MOCK), JaxMock(split, MOCK)
        assert len(got) == len(want)
        for ld in (got, want):
            ld.shuffle = shuffle
            ld.set_epoch(3)
        pairs = list(zip(got, want, strict=True))
        assert len(pairs) == len(want)
        for a, b in pairs:
            assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()


def test_shuffler_equals_jax():
    ranges = [(0, 5), (5, 12), (12, 20), (20, 21), (21, 30)]
    for size in (None, 1, 2, 10):
        for epoch in (0, 4):
            a = TwoStageShuffler(30, size, song_ranges=ranges)
            b = JaxShuffler(30, size, song_ranges=ranges)
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            assert list(a) == list(b)
            a.shuffle = b.shuffle = False
            assert list(a) == list(b) == list(range(30))
    assert list(batched(iter(range(7)), 3)) == list(jax_batched(iter(range(7)), 3))
    assert list(batched(iter(range(7)), 3, drop_last=True)) == [[0, 1, 2], [3, 4, 5]]


def test_music_cache_bytes_equal_jax(pipeline_root, tmp_path):
    got = ensure_music_cache(dict(pipeline_root, cache_dir=str(tmp_path / "port")), "train")
    want = jax_ensure_cache(dict(pipeline_root, cache_dir=str(tmp_path / "jax")), "train")
    assert os.path.basename(got) == os.path.basename(want) == "1music_train"
    for ext in (".bin", ".npy"):
        with open(got + ext, "rb") as f, open(want + ext, "rb") as g:
            assert f.read() == g.read(), ext


# ------------------------------------------------------- cues and windows
@pytest.mark.parametrize("shift_type", ["triangle", "uniform"])
@pytest.mark.parametrize("eval_time_shift", [False, True])
def test_cues_and_windows_equal_jax(pipeline_root, tmp_path, shift_type, eval_time_shift):
    cfg = _cfg(pipeline_root, tmp_path, time_shift_type=shift_type)
    got = segments.MusicSegmentDataset(cfg, "train", num_workers=1)
    want = jsegments.MusicSegmentDataset(cfg, "train", num_workers=1)
    assert np.array_equal(got.cues, want.cues) and got.song_range == want.song_range
    assert got.fftconv_n == want.fftconv_n
    W_org, W_aug = got.segment_size, got.pad_start + got.segment_size
    shift = got.pad_start + got.segment_size + max(got.time_offset, got.segment_size)
    corpus_t = torch.from_numpy(np.pad(got.f, (shift, shift)))
    corpus_j = jnp.asarray(np.pad(want.f, (shift, shift)))
    rng_a, rng_b = np.random.default_rng(1003), np.random.default_rng(1003)
    order = np.random.default_rng(0).permutation(len(got))
    for idx in np.array_split(order, 4):
        cues = got.get_batch_cues(idx.tolist(), eval_time_shift, rng_a)
        jcues = want.get_batch_cues(idx.tolist(), eval_time_shift, rng_b)
        for a, b in zip(cues, jcues):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        org_start, aug_start, lo, hi = cues
        host = (want._gather_host(org_start, lo, hi, W_org),
                want._gather_host(aug_start, lo, hi, W_aug))
        mine = (got._gather_host(org_start, lo, hi, W_org),
                got._gather_host(aug_start, lo, hi, W_aug))
        dev_j = jsegments.gather_windows(
            corpus_j, *(jnp.asarray(c.astype(np.int32)) for c in cues),
            w_org=W_org, w_aug=W_aug, shift=shift)
        dev_t = segments.gather_windows(
            corpus_t, *(torch.from_numpy(c) for c in cues),
            w_org=W_org, w_aug=W_aug, shift=shift)
        for h, m, j, t in zip(host, mine, dev_j, dev_t):
            assert h.dtype == np.int16 and t.dtype == torch.int16
            assert np.array_equal(h, m) and np.array_equal(h, np.asarray(j))
            assert np.array_equal(h, t.numpy())
    # song edges zero whole stretches of some windows
    assert (host[1] == 0).any()


# ----------------------------------------------------------- augmentation
def _signals(rng, B=5, L=4000, N=20000):
    x = (rng.standard_normal((B, L)) * 0.3).astype(np.float32)
    bank = (rng.standard_normal(N) * 0.5).astype(np.float32)
    return x, bank


@pytest.mark.parametrize("band", [False, True])
@pytest.mark.parametrize("L", [4000, 4001])
def test_add_noises_with_jax_draws(band, L):
    rng = np.random.default_rng(L)
    x, bank = _signals(rng, L=L)
    bp = augment.bass_shelf_power_response(L, 8000, -24.0, 300.0) if band else None
    np.testing.assert_array_equal(
        bp if band else 0, jaugment.bass_shelf_power_response(L, 8000, -24.0, 300.0) if band else 0)
    key = jax.random.key(L + band)
    want = np.asarray(jaugment.add_noises(
        key, jnp.asarray(x), jnp.asarray(bank), 0.0, 10.0,
        band_power=None if bp is None else jnp.asarray(bp)))
    # JAX's draws, replayed from pfann_tpu/ops/augment.py:93-98
    kidx, ksnr = jax.random.split(key)
    starts = np.asarray(jax.random.randint(kidx, (x.shape[0],), 0, bank.shape[0] - L))
    snr = np.asarray(jax.random.uniform(ksnr, (x.shape[0],), minval=0.0, maxval=10.0))
    got = augment.add_noises(
        torch.from_numpy(x), torch.from_numpy(bank), torch.from_numpy(starts).long(),
        torch.from_numpy(snr), band_power=None if bp is None else torch.from_numpy(bp))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def _banks(rng, n_fft, n_air=3, n_mic=2):
    def bank(n, length):
        ir = np.zeros((n, length), np.float32)
        ir[:, 0] = 1.0
        for i in range(n):
            taps = rng.integers(1, length, 4)
            ir[i, taps] = rng.uniform(-0.5, 0.5, 4)
        return np.fft.rfft(ir, n_fft).astype(np.complex64)

    return bank(n_air, 2000), bank(n_mic, 500)


def test_ir_convolve_with_jax_draws():
    rng = np.random.default_rng(4)
    x, _ = _signals(rng, B=6, L=3000)
    n = 8192
    air, mic = _banks(rng, n)
    key = jax.random.key(8)
    want = np.asarray(jaugment.ir_convolve(key, jnp.asarray(x), jnp.asarray(air),
                                           jnp.asarray(mic), n))
    # the JAX package's real/imag bank layout gives the same answer
    want_ri = np.asarray(jaugment.ir_convolve(
        key, jnp.asarray(x), jnp.asarray(jaugment.complex_bank(air)),
        jnp.asarray(jaugment.complex_bank(mic)), n))
    np.testing.assert_array_equal(want, want_ri)
    kair, kmic = jax.random.split(key)  # pfann_tpu/ops/augment.py:127-136
    ia = np.asarray(jax.random.randint(kair, (6,), 0, 3))
    im = np.asarray(jax.random.randint(kmic, (6,), 0, 2))
    got = augment.ir_convolve(torch.from_numpy(x), torch.from_numpy(air), torch.from_numpy(mic),
                              torch.from_numpy(ia).long(), torch.from_numpy(im).long(), n)
    assert got.shape == (6, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # and each row is the plain convolution with its chosen IRs
    ref = np.fft.irfft(np.fft.rfft(x, n) * air[ia] * mic[im], n)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)


def test_augment_chain_with_jax_draws(pipeline_root, tmp_path):
    """make_augment_fn and the port's Augment on one loader batch, with
    JAX's draws (its key splits, pfann_tpu/ops/augment.py:168-178)."""
    cfg = _cfg(pipeline_root, tmp_path)
    loader = segments.SegmentedDataLoader("train", cfg, num_workers=1, device="cpu")
    jloader = jsegments.SegmentedDataLoader("train", cfg, num_workers=1)
    ds = loader.dataset
    x_org, x_aug = ds.get_batch(list(range(0, 40, 5)), False, np.random.default_rng(1))
    key = jax.random.key(21)
    want = np.asarray(jloader._augment_fn(key, jnp.asarray(x_org), jnp.asarray(x_aug)))

    B, L = x_aug.shape
    key, k1 = jax.random.split(key)
    key, k2 = jax.random.split(key)
    kidx, ksnr = jax.random.split(k1)
    kair, kmic = jax.random.split(k2)
    aug = loader.augment
    draws = augment.AugmentDraws(
        torch.from_numpy(np.asarray(jax.random.randint(kidx, (B,), 0, aug.noise_bank.shape[0] - L))).long(),
        torch.from_numpy(np.asarray(jax.random.uniform(ksnr, (B,), minval=0.0, maxval=10.0))),
        torch.from_numpy(np.asarray(jax.random.randint(kair, (B,), 0, aug.air_spectra.shape[0]))).long(),
        torch.from_numpy(np.asarray(jax.random.randint(kmic, (B,), 0, aug.mic_spectra.shape[0]))).long(),
    )
    got = aug(torch.from_numpy(x_org), torch.from_numpy(x_aug), draws).numpy()
    assert got.shape == want.shape == (B, 2, 256, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=MEL_ATOL)
    # the port's own draws stay in range
    d = aug.draw(torch.Generator().manual_seed(0), 500)
    assert 0 <= int(d.noise_start.min()) and int(d.noise_start.max()) < aug.noise_bank.shape[0] - L
    assert 0 <= float(d.snr.min()) and float(d.snr.max()) <= 10
    assert set(d.air_idx.tolist()) <= set(range(aug.air_spectra.shape[0]))
    assert aug.air_spectra.dtype == torch.complex64


# ----------------------------------------------------------------- loader
@pytest.mark.parametrize("device_corpus", [False, True])
def test_clean_mel_batches_equal_jax_loader(pipeline_root, tmp_path, device_corpus):
    cfg = _cfg(pipeline_root, tmp_path, device_corpus=device_corpus)
    got = segments.SegmentedDataLoader("validate", cfg, num_workers=1, device="cpu")
    want = jsegments.SegmentedDataLoader("validate", cfg, num_workers=1)
    assert (got.corpus_dev is not None) == device_corpus
    for ld in (got, want):
        ld.shuffle = True
        ld.augmented = False
        ld.eval_time_shift = True
        ld.set_epoch(2)
    pairs = list(zip(got, want, strict=True))
    assert len(pairs) == len(want) == 11
    for a, b in pairs:
        assert a.shape == b.shape == (4, 1, 256, 32)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=MEL_ATOL)
    assert got.last_stats["steps"] == 11


def test_prefetch_batches_equal_plain_iteration(pipeline_root, tmp_path):
    cfg = _cfg(pipeline_root, tmp_path)
    loader = segments.SegmentedDataLoader("train", cfg, num_workers=1, device="cpu")
    loader.set_epoch(1)
    plain = list(loader)
    fetched = list(prefetch(iter(loader)))
    assert len(plain) == len(fetched) == len(loader)
    for a, b in zip(plain, fetched):
        assert a.shape == (4, 2, 256, 32) and torch.equal(a, b)
    # augmented: the aug row differs from the org row
    assert float((plain[0][:, 0] - plain[0][:, 1]).abs().max()) > 0.1


def test_prefetch_order_errors_and_early_stop():
    assert list(prefetch(iter(range(50)))) == list(range(50))

    def boom():
        yield 1
        raise ValueError("boom")

    it = prefetch(boom())
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        list(it)
    produced = []

    def gen():
        for i in range(1000):
            produced.append(i)
            yield i

    it = prefetch(gen(), depth=2)
    for x in it:
        if x == 3:
            break
    it.close()
    assert len(produced) < 20


# ------------------------------------------------------------ entry points
def test_train_cli_real_pipeline_one_epoch(pipeline_root, tmp_path):
    cfg = _cfg(pipeline_root, tmp_path)
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    r = subprocess.run(
        [sys.executable, "-m", "pfann_tpu_torch.train", "-p", cfg_path, "-w", "2",
         "--device", "cpu"],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    loss = float(r.stdout.split("loss: ")[1].split()[0])
    assert np.isfinite(loss)
    assert "validate score" in r.stdout
    md = cfg["model_dir"]
    for name in ("checkpoint0.ckpt", "epochs.txt", "configs.json", "metrics.jsonl",
                 "model.msgpack"):
        assert os.path.exists(os.path.join(md, name)), name
    with open(os.path.join(md, "metrics.jsonl")) as f:
        tags = {json.loads(ln)["tag"] for ln in f}
    assert {"train/host_s", "train/dispatch_s", "train/epoch_s"} <= tags


def test_preview_writes_wavs(pipeline_root, tmp_path):
    from pfann_tpu_torch.audio.io import get_audio
    from pfann_tpu_torch.preview import main

    cfg = _cfg(pipeline_root, tmp_path)
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    out = tmp_path / "preview"
    main(["preview", "-p", cfg_path, "-o", str(out), "-n", "2", "--device", "cpu"])
    names = sorted(os.listdir(out))
    assert names == ["batch0.wav", "batch1.wav"]
    wav, sr = get_audio(str(out / names[0]))
    # 4 pairs of 1 s segments, interleaved org/aug, peak-normalised
    assert sr == 8000 and wav.shape[-1] == 8 * 8000
    assert np.isfinite(wav).all() and 0.9 < np.abs(wav).max() <= 1.0


def test_synthetic_demo_on_cpu(tmp_path, capsys):
    from pfann_tpu_torch.tools import synthetic_demo

    synthetic_demo.main(["synthetic_demo", str(tmp_path / "demo"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "== song accuracy:" in out
    for name in ("embeddings", "landmarkKey", "songList.txt", "model.msgpack"):
        assert os.path.exists(tmp_path / "demo" / "db" / name)
