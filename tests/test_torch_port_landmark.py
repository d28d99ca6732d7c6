"""The port's landmark arm against the JAX package: the torch-op peak
extractor (pfann_tpu_torch/landmark/device.py) on the CPU against JAX's
DevicePeakExtractor (XLA on the CPU) and the numpy reference
(core.find_peaks(core.spectrogram(w))), and the port's lm_builder /
lm_matcher against the JAX CLIs on the corpus of tests/test_landmark.py.

Tolerances: peaks and packed masks are compared exactly on the JAX
test's signals (there torch's rfft on the CPU, XLA's and numpy's give the
same peaks), and so are the CLI outputs, except the landmark index of the
torch extractor's build (see test_lm_cli_matches_jax).  The log-spectra differ in the FFT's f32
rounding, which is absolute (~1e-7 of a frame's sum |x|): the magnitudes
|X| + 1e-6 agree within rtol 1e-3 and atol 1e-5 (measured: rel 2.6e-4
where |X| > 1e-3, 2.3e-3 below it; abs 3.1e-5 at most).
"""

import csv
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfann_tpu.audio.io import write_wav
from pfann_tpu.landmark import core as jax_core
from pfann_tpu.landmark.device import DevicePeakExtractor as JaxExtractor
from pfann_tpu_torch import lm_builder, lm_matcher
from pfann_tpu_torch.landmark import core
from pfann_tpu_torch.landmark.device import (
    DevicePeakExtractor,
    as_device_input,
    log_spectrogram,
    peak_mask,
)
from tests.conftest import run_cli_inproc
from tests.test_landmark import SR, make_song
from tests.test_landmark_device import _song

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference(w):
    """numpy peaks of a signal as the host pipeline sees it (int16 /32768)."""
    f32 = w.astype(np.float32) / 32768 if w.dtype == np.int16 else w
    return jax_core.find_peaks(jax_core.spectrogram(f32))


def _to_int16(w):
    return (np.clip(w, -1, 1) * 32767).astype(np.int16)


# the JAX test's lengths: frame-bucket padding, a non-hop-multiple tail,
# a sub-N_FFT zero pad, silence, and one 30 s song (a 960-frame bucket)
SIGNALS = [_song(0, 3.0), _song(1, 1.3), _song(2, 5.01), _song(3, 0.05),
           np.zeros(400, np.float32), _song(12, 30.0)]


@pytest.fixture(scope="module")
def jax_peaks():
    return JaxExtractor(batch=3).extract(SIGNALS)


def test_core_is_the_jax_core():
    w = SIGNALS[0]
    np.testing.assert_array_equal(core.spectrogram(w), jax_core.spectrogram(w))
    h, t = core.extract_hashes(w)
    jh, jt = jax_core.extract_hashes(w)
    np.testing.assert_array_equal(h, jh)
    np.testing.assert_array_equal(t, jt)


@pytest.mark.parametrize("batch", [3, 32])
def test_peaks_equal_jax_and_numpy(jax_peaks, batch):
    port = DevicePeakExtractor(batch=batch, device="cpu").extract(SIGNALS)
    for i, w in enumerate(SIGNALS):
        ref = _reference(w)
        assert port[i].dtype == np.int32 and port[i].shape == ref.shape, i
        np.testing.assert_array_equal(port[i], ref, err_msg="signal %d" % i)
        np.testing.assert_array_equal(port[i], jax_peaks[i], err_msg="signal %d" % i)


def test_log_spectrogram_matches_numpy():
    ex = DevicePeakExtractor(device="cpu")
    for w in SIGNALS[:3] + SIGNALS[5:]:
        ref = jax_core.spectrogram(w).T  # [T, F]
        buf, _ = ex.stage_chunk([(0, w, ref.shape[0])])
        spec = log_spectrogram(buf)[0, : ref.shape[0]].numpy()
        np.testing.assert_allclose(np.exp(spec), np.exp(ref), rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_packed_mask_bitwise_equals_jax_fn(dtype):
    """One staged chunk through the port's peak_mask and JAX's jitted
    function: the same uint8 bytes."""
    wavs = [SIGNALS[0], SIGNALS[2], SIGNALS[1]]
    if dtype == "int16":
        wavs = [_to_int16(w) for w in wavs]
    ex = DevicePeakExtractor(device="cpu")
    chunk = [(i, w, 1 + (len(w) - core.N_FFT) // core.HOP) for i, w in enumerate(wavs)]
    buf, valid = ex.stage_chunk(chunk)
    assert buf.dtype == getattr(torch, dtype)
    port = peak_mask(buf, valid).numpy()
    ref = np.asarray(JaxExtractor()._make_fn()(jnp.asarray(buf.numpy()),
                                               jnp.asarray(valid.numpy())))
    assert port.dtype == np.uint8 and port.shape == ref.shape == (3, 513, 24)
    np.testing.assert_array_equal(port, ref)
    assert port.any()


def test_int16_input_matches_float():
    w = _song(4, 2.0)
    q = _to_int16(w)  # a "decoded WAV"
    f = q.astype(np.float32) / 32768
    di = as_device_input(f)
    assert di.dtype == np.int16  # exact int16 representation detected
    a, b = DevicePeakExtractor(batch=2, device="cpu").extract([di, f])
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, _reference(f))
    assert as_device_input(f * 0.7071067).dtype == np.float32


def test_mixed_dtype_chunk_rescales_int16():
    """An int16 signal sharing a chunk with a float32 one is rescaled on
    the host (a quiet signal's peaks move near the log floor if not)."""
    w = 1e-3 / 0.6 * _song(4, 2.0)  # quiet: int16 range ~ +-32
    q = _to_int16(w)
    mixed, _ = DevicePeakExtractor(batch=2, device="cpu").extract([q, _song(5, 2.0)])
    np.testing.assert_array_equal(mixed, _reference(q))


def test_bucket_boundary_with_remainder_samples():
    """nf == 64 == the bucket, plus 100 samples past the last complete
    frame: clipped to the bucketed buffer, in int16 and f32."""
    n = 1024 + 63 * 256 + 100  # 17252
    w = _song(11, (n + 1) / 8000.0)[:n]
    assert 1 + (w.shape[0] - 1024) // 256 == 64
    ex = DevicePeakExtractor(batch=2, device="cpu")
    jex = JaxExtractor(batch=2)
    for wav in (w, _to_int16(w)):
        port = ex.extract([wav])[0]
        np.testing.assert_array_equal(port, _reference(wav))
        np.testing.assert_array_equal(port, jex.extract([wav])[0])


@pytest.mark.parametrize("batch", [1, 2])
def test_drain_while_dispatching(monkeypatch, batch):
    """pipeline=2 with more chunks than that: chunks drain while later
    ones are dispatched, and results come back in input order."""
    lengths = (2.0, 0.7, 4.1, 1.0, 3.3, 2.5, 0.3)
    wavs = [_song(20 + i, s) for i, s in enumerate(lengths)]
    wavs[3] = _to_int16(wavs[3])
    ex = DevicePeakExtractor(batch=batch, pipeline=2, device="cpu")
    events = []
    dispatch, drain = ex._dispatch_chunk, ex._drain_chunk

    def spy_dispatch(chunk):
        events.append("dispatch")
        return dispatch(chunk)

    def spy_drain(*args):
        events.append("drain")
        return drain(*args)

    monkeypatch.setattr(ex, "_dispatch_chunk", spy_dispatch)
    monkeypatch.setattr(ex, "_drain_chunk", spy_drain)
    port = ex.extract(wavs)
    n_chunks = -(-len(wavs) // batch)
    assert events.count("dispatch") == events.count("drain") == n_chunks
    assert events.index("drain") < len(events) - 1 - events[::-1].index("dispatch")
    in_flight = np.cumsum([1 if e == "dispatch" else -1 for e in events])
    assert in_flight.max() == 2
    jax_out = JaxExtractor(batch=8).extract(wavs)
    for i, w in enumerate(wavs):
        np.testing.assert_array_equal(port[i], _reference(w), err_msg="song %d" % i)
        np.testing.assert_array_equal(port[i], jax_out[i], err_msg="song %d" % i)


def test_build_with_extractor_matches_host():
    wavs = [_song(5, 2.0), _song(6, 2.0), _song(7, 2.0)]
    host = jax_core.LandmarkIndex.build(iter(wavs), song_list=["a", "b", "c"])
    port = core.LandmarkIndex.build(iter(wavs), song_list=["a", "b", "c"],
                                    extractor=DevicePeakExtractor(batch=2, device="cpu"))
    assert port.n_songs == host.n_songs == 3
    np.testing.assert_array_equal(port.hashes, host.hashes)
    np.testing.assert_array_equal(port.songs, host.songs)
    np.testing.assert_array_equal(port.anchors, host.anchors)
    best, table = port.query(wavs[1][:8000])
    best_h, table_h = host.query(wavs[1][:8000])
    assert best == best_h == 1
    np.testing.assert_array_equal(table, table_h)


def test_extractor_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        DevicePeakExtractor()


# ------------------------------------------------------------------ CLIs
@pytest.fixture(scope="module")
def lm_files(tmp_path_factory):
    """tests/test_landmark.py's 6 songs x 16 s as WAVs, and 4 noisy 5 s
    crops: (db list, query list, query paths, answers)."""
    root = tmp_path_factory.mktemp("lm_port")
    songs = [make_song(i) for i in range(6)]
    paths = []
    for i, s in enumerate(songs):
        p = str(root / ("s%d.wav" % i))
        write_wav(p, s, SR)
        paths.append(p)
    db_list = str(root / "db.txt")
    with open(db_list, "w") as f:
        f.writelines(p + "\n" for p in paths)
    rng = np.random.default_rng(3)
    qpaths, answers = [], []
    for qi in range(4):
        sid = int(rng.integers(0, len(songs)))
        start = int(rng.integers(0, SR * 8))
        q = songs[sid][start : start + SR * 5].copy()
        q += 0.2 * rng.standard_normal(q.shape).astype(np.float32)
        p = str(root / ("q%d.wav" % qi))
        write_wav(p, 0.5 * q / np.abs(q).max(), SR)
        qpaths.append(p)
        answers.append((paths[sid], start / SR))
    qlist = str(root / "qlist.txt")
    with open(qlist, "w") as f:
        f.writelines(p + "\n" for p in qpaths)
    return root, db_list, qlist, qpaths, answers


def _run_lm(root, db_list, qlist, tag, run_builder, run_matcher):
    db_dir, result = str(root / (tag + "_db")), str(root / (tag + "_result.txt"))
    run_builder(db_list, db_dir)
    run_matcher(qlist, db_dir, result)
    return db_dir, result


@pytest.fixture(scope="module")
def jax_lm(lm_files):
    """The JAX CLIs on the CPU backend (their numpy host path)."""
    root, db_list, qlist, _, _ = lm_files
    return _run_lm(root, db_list, qlist, "jax",
                   lambda *a: run_cli_inproc(os.path.join(REPO, "lm_builder.py"), list(a)),
                   lambda *a: run_cli_inproc(os.path.join(REPO, "lm_matcher.py"), list(a)))


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _triples(db_dir):
    with np.load(os.path.join(db_dir, "landmarks.npz")) as z:
        assert sorted(z.files) == ["anchors", "hashes", "songs"]
        assert all(z[k].dtype == np.int32 for k in z.files)
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("lm_device", ["extractor", "host"])
def test_lm_cli_matches_jax(lm_files, jax_lm, monkeypatch, lm_device):
    """The port's CLIs with --device cpu against the JAX CLIs on the CPU
    backend (the numpy path).  Under PFANN_LM_DEVICE=0 the port runs the
    same numpy path: every file is equal.  With the torch extractor the
    TSV, .csv, .bin, songList.txt and lm_meta.json are byte-equal, and
    landmarks.npz agrees on >= 0.999 of its (hash, song, anchor) triples
    (measured 0.99948: 12 of 47,990).  On this corpus the median gate sits
    in the 16-bit quantisation floor, where the f32 FFT's rounding is a
    large share of a bin, so cells near the gate flip; JAX's own device
    extractor differs from its numpy path there as well (ROADMAP.md §3,
    reference behaviour 2)."""
    root, db_list, qlist, qpaths, answers = lm_files
    if lm_device == "host":
        monkeypatch.setenv("PFANN_LM_DEVICE", "0")
    else:
        monkeypatch.delenv("PFANN_LM_DEVICE", raising=False)
    db_dir, result = _run_lm(
        root, db_list, qlist, "port_" + lm_device,
        lambda *a: lm_builder.main(["lm_builder", *a, "--device", "cpu"]),
        lambda *a: lm_matcher.main(["lm_matcher", *a, "--device", "cpu"]))
    jdb, jresult = jax_lm
    port, ref = _triples(db_dir), _triples(jdb)
    if lm_device == "host":
        for name in ref:
            np.testing.assert_array_equal(port[name], ref[name])
    else:
        a = set(zip(*(port[k].tolist() for k in ("hashes", "songs", "anchors"))))
        b = set(zip(*(ref[k].tolist() for k in ("hashes", "songs", "anchors"))))
        assert len(a & b) >= 0.999 * max(len(a), len(b)), (len(a & b), len(a), len(b))
        assert np.all(np.diff(port["hashes"]) >= 0)
    for name in ("songList.txt", "lm_meta.json"):
        assert _bytes(os.path.join(db_dir, name)) == _bytes(os.path.join(jdb, name)), name
    for ext in ("", ".csv", ".bin"):
        assert _bytes(result + ext) == _bytes(jresult + ext), "result" + ext
    with open(result) as f:
        assert [ln.split("\t")[1].rstrip("\n") for ln in f] == [a for a, _ in answers]
    assert os.path.getsize(result + ".bin") == len(qpaths) * 6 * 2 * 4


def test_lmscore_runs_on_port_outputs(lm_files, jax_lm, monkeypatch, tmp_path):
    root, db_list, qlist, qpaths, answers = lm_files
    monkeypatch.delenv("PFANN_LM_DEVICE", raising=False)
    _, result = _run_lm(
        root, db_list, qlist, "port_lmscore",
        lambda *a: lm_builder.main(["lm_builder", *a, "--device", "cpu"]),
        lambda *a: lm_matcher.main(["lm_matcher", *a, "--device", "cpu"]))
    expected = str(tmp_path / "expected.csv")
    with open(expected, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["query", "answer", "time"])
        for qp, (ans, t0) in zip(qpaths, answers):
            w.writerow([qp, ans, t0])
    scores = {}
    for tag, res in (("port", result), ("jax", jax_lm[1])):
        out = str(tmp_path / (tag + ".npy"))
        run_cli_inproc(os.path.join(REPO, "ensemble", "lmscore.py"),
                       [db_list, expected, res, out])
        scores[tag] = np.load(out)
    assert scores["port"].shape == (4, 2)
    assert (scores["port"][:, 1] == 1).all() and (scores["port"][:, 0] > 0).all()
    np.testing.assert_array_equal(scores["port"], scores["jax"])


@pytest.mark.parametrize("flag", [["--device", "cuda"], []])
def test_lm_cli_cuda_without_card_raises(lm_files, monkeypatch, flag):
    """cuda (asked for, or by default) where no card is visible raises,
    also under PFANN_LM_DEVICE=0: no quiet move to the CPU."""
    root, db_list, qlist, _, _ = lm_files
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("PFANN_LM_DEVICE", "0")
    with pytest.raises(RuntimeError, match="cuda"):
        lm_builder.main(["lm_builder", db_list, str(root / "nodb"), *flag])
    with pytest.raises(RuntimeError, match="cuda"):
        lm_matcher.main(["lm_matcher", qlist, str(root / "nodb"),
                         str(root / "never.txt"), *flag])
    assert not os.path.exists(str(root / "nodb"))
