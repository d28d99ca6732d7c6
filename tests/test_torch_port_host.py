"""The port's copies of the JAX package's host modules behave as the originals.

``pfann_tpu_torch.{audio,data,utils}`` hold copies of what the port uses
of ``pfann_tpu.audio``, ``pfann_tpu.data.musicdata`` and
``pfann_tpu.utils`` (config, logging, ``int16_if_exact``).  Each is held
to its original on the same inputs, made from a numpy seed: equal arrays,
equal bytes, equal results.
"""

import json
import logging

import numpy as np
import pytest

from pfann_tpu.audio import io as jio
from pfann_tpu.audio import stream as jstream
from pfann_tpu.audio.resample import resample as jresample
from pfann_tpu.data import musicdata as jmusic
from pfann_tpu.utils import config as jconfig
from pfann_tpu.utils import fastcast as jfastcast
from pfann_tpu.utils import logging as jlogging
from pfann_tpu_torch.audio import io as tio
from pfann_tpu_torch.audio import stream as tstream
from pfann_tpu_torch.audio.resample import resample as tresample
from pfann_tpu_torch.data import musicdata as tmusic
from pfann_tpu_torch.utils import config as tconfig
from pfann_tpu_torch.utils import fastcast as tfastcast
from pfann_tpu_torch.utils import logging as tlogging

PARAMS = {"sample_rate": 8000, "segment_size": 1, "hop_size": 0.5,
          "indexer": {"frame_shift_mul": 1}}


def _signal(rng, channels, n):
    return (0.5 * rng.standard_normal((channels, n))).clip(-1, 1).astype(np.float32)


@pytest.fixture()
def wavs(tmp_path):
    """Four WAVs (mono and stereo, 8/16/44.1 kHz, one shorter than a
    segment, one fake stereo) written by the original writer, and their
    list file."""
    rng = np.random.default_rng(0)
    specs = [(1, 8000, 3 * 8000), (2, 16000, 2 * 16000 + 77), (1, 44100, 44100 * 3 // 2),
             (1, 8000, 3000)]
    paths = []
    for i, (ch, rate, n) in enumerate(specs):
        x = _signal(rng, ch, n)
        path = tmp_path / ("s%d.wav" % i)
        jio.write_wav(path, x if ch > 1 else x[0], rate)
        paths.append(str(path))
    fake = _signal(rng, 1, 8000 * 2)[0]
    path = tmp_path / "fake_stereo.wav"
    jio.write_wav(path, np.stack([fake, -fake]), 8000)
    paths.append(str(path))
    lst = tmp_path / "list.txt"
    lst.write_text("".join(p + "\n" for p in paths))
    return str(lst), paths


@pytest.mark.parametrize("streaming", [True, False])
def test_music_dataset_equal(wavs, streaming):
    lst, _ = wavs
    params = dict(PARAMS, streaming=streaming)
    a, b = jmusic.MusicDataset(lst, params), tmusic.MusicDataset(lst, params)
    assert a.files == b.files and len(a) == len(b) == 5
    for (ia, na, wa), (ib, nb, wb) in zip(a.iterate(), b.iterate(num_workers=2)):
        assert (ia, na) == (ib, nb) and wa.dtype == wb.dtype
        np.testing.assert_array_equal(wa, wb)
    for ra, rb in zip(a.iterate_raw(), b.iterate_raw(num_workers=2, prefetch=3)):
        assert ra[:2] == rb[:2] and ra[3] == rb[3] and ra[2].dtype == rb[2].dtype
        np.testing.assert_array_equal(ra[2], rb[2])


def test_music_dataset_broken_file(tmp_path):
    """A file that does not decode gives the empty rows of the original."""
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav")
    lst = tmp_path / "l.txt"
    lst.write_text(str(bad) + "\n")
    a = jmusic.MusicDataset(str(lst), PARAMS).load(0)
    b = tmusic.MusicDataset(str(lst), PARAMS).load(0)
    assert a[:2] == b[:2] and a[2].shape == b[2].shape == (0, 8000)


@pytest.mark.parametrize("channels", [1, 2])
def test_write_wav_equal_bytes(tmp_path, channels):
    x = _signal(np.random.default_rng(channels), channels, 5000) * 1.5  # some clip
    x = x if channels > 1 else x[0]
    jio.write_wav(tmp_path / "a.wav", x, 22050)
    tio.write_wav(tmp_path / "b.wav", x, 22050)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()


def test_get_audio_and_stream_equal(wavs):
    _, paths = wavs
    for p in paths:
        (xa, ra), (xb, rb) = jio.get_audio(p), tio.get_audio(p)
        assert ra == rb
        np.testing.assert_array_equal(xa, xb)
        (sa, qa), (sb, qb) = (jstream.stream_audio_resampled(p, 8000, chunk_seconds=0.3,
                                                              block_seconds=0.7),
                              tstream.stream_audio_resampled(p, 8000, chunk_seconds=0.3,
                                                              block_seconds=0.7))
        assert qa == qb
        np.testing.assert_array_equal(sa, sb)


@pytest.mark.parametrize("orig,new", [(8000, 8000), (16000, 8000), (44100, 8000),
                                      (22050, 16000)])
def test_resample_equal(orig, new):
    x = _signal(np.random.default_rng(orig), 2, 3 * orig + 13)
    np.testing.assert_array_equal(jresample(x, orig, new), tresample(x, orig, new))


def test_read_config_and_file_list_equal(tmp_path):
    cfg = {"sample_rate": 8000, "indexer": {"top_k": 100, "align_pad": 32},
           "name": "ünïcode", "list": [1, 2.5, None]}
    (tmp_path / "c.json").write_text(json.dumps(cfg))
    assert jconfig.read_config(str(tmp_path / "c.json")) == tconfig.read_config(
        str(tmp_path / "c.json")) == cfg
    (tmp_path / "l.txt").write_text("a.wav\nb c.wav\n\nlast.wav")
    (tmp_path / "l.csv").write_text("path,label\nx.wav,1\n\"y,z.wav\",2\n")
    for name in ("l.txt", "l.csv"):
        path = str(tmp_path / name)
        assert jconfig.read_file_list(path) == tconfig.read_file_list(path)
    assert tconfig.read_file_list(str(tmp_path / "l.csv")) == ["x.wav", "y,z.wav"]


def test_int16_if_exact_and_unfold_equal():
    rng = np.random.default_rng(5)
    exact = rng.integers(-32767, 32768, size=999) / 32768.0
    for w in (exact, exact * 0.3, np.zeros(10)):
        a, b = jfastcast.int16_if_exact(w), tfastcast.int16_if_exact(w)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    x = rng.standard_normal(1000).astype(np.float32)
    for size, hop in ((100, 50), (1000, 1), (1001, 4)):
        np.testing.assert_array_equal(jmusic.unfold(x, size, hop), tmusic.unfold(x, size, hop))


def test_logging_equal(tmp_path):
    """Both write the same log file name and line format, through the same
    multiprocessing logger."""
    assert tlogging.get_logger() is jlogging.get_logger()
    ja = jlogging.MultiProcessInitLogger("app", str(tmp_path / "j"))
    ta = tlogging.MultiProcessInitLogger("app", str(tmp_path / "t"))
    assert ja.log_name[:4] == ta.log_name[:4] == "app-"
    logger = tlogging.get_logger()
    before, level = list(logger.handlers), logger.level
    try:
        tlogging.init_logger("x", str(tmp_path / "t"))
        assert logger.level == logging.INFO
        jlogging.init_logger("x", str(tmp_path / "j"))
        logger.info("hello %d", 7)
        for h in logger.handlers:
            h.flush()
    finally:
        for h in logger.handlers[len(before):]:
            h.close()
        logger.handlers[:] = before
        logger.setLevel(level)
    lines = [(tmp_path / d / "x.log").read_text().split("] ", 2)[2] for d in ("j", "t")]
    assert lines[0] == lines[1] == "hello 7\n"
