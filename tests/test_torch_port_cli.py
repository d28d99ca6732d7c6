"""The port's side CLIs and saliency against their JAX twins.

Reuses the ``corpus`` and ``db_and_model`` fixtures of tests/test_e2e.py
(a briefly trained tiny model and a JAX-built DB over 5 synthetic songs)
and ``pipeline_root`` of tests/conftest.py (music, noise, IR corpora).
Each JAX CLI runs in-process (``run_cli_inproc``), each port CLI through
its ``main`` with ``--device cpu``, on the same inputs.

Tolerances: embeddings within 2e-2 (both embed in bf16, see
test_torch_port_slice.py); scores within 2e-2; song ids, times and TSV
bytes equal.  genquery is numpy on the host in both: its WAVs and ground
truth are byte-equal.  Saliency gradients agree within 5e-2 of each
(segment, frame) column's max |dg| on at least 99% of entries in f32; in
bf16 (noisy backward passes in both packages) the port's agrees so with
JAX's f32 gradient on at least 95%.
"""

import csv
import json
import os
import shutil
import struct
import zlib

import numpy as np
import pytest

from pfann_tpu.audio.io import write_wav
from pfann_tpu.index.embedder import Embedder as JaxEmbedder
from pfann_tpu.index.saliency import saliency_image as jax_saliency_image
from pfann_tpu_torch import cppmatcher, extractemb, genquery, matchemb, matchfromgt
from pfann_tpu_torch import matcher, rebuild
from pfann_tpu_torch.index.embedder import Embedder
from pfann_tpu_torch.index.saliency import png_bytes, save_saliency_png, saliency_image
from tests.conftest import run_cli_inproc
from tests.test_e2e import corpus, db_and_model  # noqa: F401  (fixtures)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EMB_ATOL = 2e-2
SCORE_ATOL = 2e-2


def _port(cli, *argv):
    cli.main([cli.__name__, *map(str, argv), "--device", "cpu"])


def _jax(script, *argv):
    run_cli_inproc(os.path.join(REPO, script), list(argv))


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def queries(corpus, tmp_path_factory):  # noqa: F811
    """4 hop-aligned 3 s crops, their list, and a ground-truth TSV (query
    stem -> song stem) with the crop offsets."""
    root = tmp_path_factory.mktemp("cli_queries")
    rng = np.random.default_rng(31)
    paths, gt, offsets = [], [], []
    for qi in range(4):
        song = int(rng.integers(0, len(corpus)))
        path, wav = corpus[song]
        start = int(rng.integers(0, len(wav) - 3 * 8000) // 4000 * 4000)
        qpath = str(root / f"c{qi}.wav")
        write_wav(qpath, wav[start : start + 3 * 8000].copy(), 8000)
        paths.append(qpath)
        gt.append("c%d\t%s\n" % (qi, os.path.splitext(os.path.basename(path))[0]))
        offsets.append(start / 8000)
    qlist = str(root / "qlist.txt")
    with open(qlist, "w") as f:
        f.writelines(p + "\n" for p in paths)
    gt_path = str(root / "gt.tsv")
    with open(gt_path, "w") as f:
        f.writelines(gt)
    return qlist, gt_path, offsets


@pytest.fixture(scope="module")
def extracted(db_and_model, queries, tmp_path_factory):  # noqa: F811
    """extractemb of both packages on the same queries."""
    _, db_dir = db_and_model
    qlist, _, _ = queries
    root = tmp_path_factory.mktemp("extract")
    jdir, tdir = str(root / "jax"), str(root / "port")
    _jax("extractemb.py", qlist, db_dir, jdir)
    _port(extractemb, qlist, db_dir, tdir)
    return jdir, tdir


def test_extractemb_matches_jax(extracted):
    jdir, tdir = extracted
    for name in ("query_index", "queryList.txt", "configs.json"):
        assert _bytes(os.path.join(tdir, name)) == _bytes(os.path.join(jdir, name)), name
    idx = np.fromfile(os.path.join(tdir, "query_index"), np.int64).reshape(-1, 2)
    assert idx.tolist() == [[5 * i, 5] for i in range(4)]  # 3 s -> 5 segments
    te = np.fromfile(os.path.join(tdir, "query_embeddings"), np.float32).reshape(-1, 16)
    je = np.fromfile(os.path.join(jdir, "query_embeddings"), np.float32).reshape(-1, 16)
    np.testing.assert_allclose(te, je, rtol=0, atol=EMB_ATOL)


@pytest.mark.parametrize("pairs", [False, True])
def test_matchemb_matches_jax(db_and_model, extracted, tmp_path, pairs):  # noqa: F811
    """On JAX's embeddings the port's TSV is byte-equal to JAX matchemb's
    (also in --pairs mode); on the port's own embeddings the answers are
    the same."""
    _, db_dir = db_and_model
    jdir, tdir = extracted
    out = {k: str(tmp_path / ("%s.txt" % k)) for k in ("jax", "port", "port_own")}
    if pairs:
        _jax("matchemb.py", "--pairs", db_dir, jdir, out["jax"])
        _port(matchemb, "--batch", 3, "--pairs", db_dir, jdir, out["port"], tdir,
              out["port_own"])
    else:
        _jax("matchemb.py", jdir, db_dir, out["jax"])
        _port(matchemb, jdir, db_dir, out["port"])
        _port(matchemb, tdir, db_dir, out["port_own"])
    assert _bytes(out["port"]) == _bytes(out["jax"])
    assert _bytes(out["port_own"]) == _bytes(out["jax"])
    got, want = (_rows(os.path.splitext(out[k])[0] + "_detail.csv") for k in ("port", "jax"))
    assert len(got) == len(want) == 5
    for g, w in zip(got[1:], want[1:]):
        assert g[:2] == w[:2] and g[3] == w[3]
        assert float(g[2]) == pytest.approx(float(w[2]), abs=SCORE_ATOL)
    tb = np.fromfile(out["port"] + ".bin", np.float32)
    jb = np.fromfile(out["jax"] + ".bin", np.float32)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=SCORE_ATOL)


def test_rebuild_matches_jax(db_and_model, tmp_path):  # noqa: F811
    """rebuild on two copies of the DB (indexer edited) writes equal
    index_meta.json bytes."""
    _, db_dir = db_and_model
    dirs = []
    for name in ("jax", "port"):
        d = str(tmp_path / name)
        shutil.copytree(db_dir, d)
        cfg = json.load(open(os.path.join(d, "configs.json")))
        cfg["indexer"].update(top_k=7, index_factory="IVF200,PQ64x8np", align_pad=40)
        with open(os.path.join(d, "configs.json"), "w") as f:
            json.dump(cfg, f)
        dirs.append(d)
    _jax("rebuild.py", dirs[0])
    rebuild.main(["rebuild", dirs[1]])
    metas = [_bytes(os.path.join(d, "index_meta.json")) for d in dirs]
    assert metas[0] == metas[1]
    meta = json.loads(metas[1])
    assert meta["ntotal"] == 75 and meta["align_pad"] == 40 and "index_factory" not in meta


def test_matchfromgt_matches_jax(db_and_model, queries, tmp_path):  # noqa: F811
    """Equal answers and times (the crop offsets), scores within 2e-2."""
    _, db_dir = db_and_model
    qlist, gt, offsets = queries
    jout, tout = str(tmp_path / "j.csv"), str(tmp_path / "t.csv")
    _jax("matchfromgt.py", qlist, gt, db_dir, jout)
    _port(matchfromgt, qlist, gt, db_dir, tout)
    got, want = _rows(tout), _rows(jout)
    assert got[0] == want[0] and len(got) == len(want) == 5
    for g, w, off in zip(got[1:], want[1:], offsets):
        assert g[:2] == w[:2] and float(g[3]) == float(w[3]) == off
        assert float(g[2]) == pytest.approx(float(w[2]), abs=5 * SCORE_ATOL)
        assert len(g) == len(w)
        for a, b in zip(g[4::3], w[4::3]):  # per-segment scores
            assert float(a) == pytest.approx(float(b), abs=SCORE_ATOL)


def test_cppmatcher_matches_jax(db_and_model, queries, tmp_path):  # noqa: F811
    """The port embeds and pipes to its own build of the native matcher:
    the TSV is byte-equal to the JAX cppmatcher's."""
    if shutil.which("g++") is None or shutil.which("make") is None:
        pytest.skip("no g++/make to build the native matcher")
    _, db_dir = db_and_model
    qlist, _, _ = queries
    jout, tout = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    _jax("cppmatcher.py", qlist, db_dir, jout)
    _port(cppmatcher, qlist, db_dir, tout)
    assert _bytes(tout) == _bytes(jout)
    assert "error" not in _bytes(tout).decode()


def test_genquery_matches_jax(pipeline_root, tmp_path):
    """Same seeds, same bytes: WAVs, expected.csv, configs.json; list.txt
    differs only by the output directory."""
    cfg = dict(pipeline_root, test_csv=pipeline_root["train_csv"])
    cfg_path = str(tmp_path / "gen.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    jdir, tdir = str(tmp_path / "jq"), str(tmp_path / "tq")
    args = ["-p", cfg_path, "-l", "1.5", "--num", "3", "--mode", "test", "--yes"]
    _jax("genquery.py", *args, "-o", jdir)
    genquery.main(["genquery", *args, "-o", tdir])
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) and len(names) == 6  # 3 wavs + 3 files
    for name in names:
        a, b = _bytes(os.path.join(jdir, name)), _bytes(os.path.join(tdir, name))
        if name == "list.txt":
            a = a.replace(jdir.encode(), tdir.encode())
        assert a == b, name


# ------------------------------------------------------------ saliency
def _segments(corpus):  # noqa: F811
    """3 s of song 1 as de-meaned 1 s segments at a 0.5 s hop."""
    from pfann_tpu.data.musicdata import unfold

    segs = unfold(corpus[1][1][: 3 * 8000], 8000, 4000)
    return (segs - segs.mean(axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def saliency_runs(db_and_model, corpus):  # noqa: F811
    """embed_with_saliency of both packages, computing in bf16 (the
    default) and in f32: {(package, dtype): (z, dg, g)}."""
    import jax.numpy as jnp
    import torch

    cfg, db_dir = db_and_model
    segs = _segments(corpus)
    model = os.path.join(db_dir, "model.msgpack")
    out = {}
    for name, jdt, tdt in (("bf16", jnp.bfloat16, torch.bfloat16),
                           ("f32", jnp.float32, torch.float32)):
        out["jax", name] = JaxEmbedder(cfg, model, compute_dtype=jdt).embed_with_saliency(segs)
        out["port", name] = Embedder(cfg, model, "cpu", compute_dtype=tdt
                                     ).embed_with_saliency(segs)
    return out


def _close(a, b):
    """Share of dg entries within 5e-2 of their (segment, frame) column's
    max |dg| (of b)."""
    scale = np.maximum(np.abs(b).max(axis=1, keepdims=True), 1e-12)
    return float(np.mean(np.abs(a - b) <= 5e-2 * scale))


def test_embed_with_saliency_matches_jax(saliency_runs):
    """In f32, dg agrees on >= 99% of entries.  A bf16 backward pass is
    noisy in either package: here JAX's own bf16 dg meets that criterion
    against its f32 dg on 96.8% of entries (75% with random weights), and
    the port's rounds at other points; so in bf16 the port's dg is held to
    JAX's f32 dg on >= 95% (95.9% measured).  Embeddings within 2e-2 and
    mel inputs equal up to f32 rounding in both."""
    for name in ("bf16", "f32"):
        (jz, jdg, jg), (tz, tdg, tg) = saliency_runs["jax", name], saliency_runs["port", name]
        assert tz.shape == (5, 16) and tdg.shape == tg.shape == jdg.shape == (5, 256, 32)
        np.testing.assert_allclose(tz, jz, rtol=0, atol=EMB_ATOL)
        np.testing.assert_allclose(np.linalg.norm(tz, axis=1), 1.0, atol=1e-5)
        # log-mel: f32 DFT matmuls in other orders; 3e-4 relative at most here
        np.testing.assert_allclose(tg, jg, rtol=1e-3, atol=2e-3)
    assert _close(saliency_runs["port", "f32"][1], saliency_runs["jax", "f32"][1]) >= 0.99
    assert _close(saliency_runs["port", "bf16"][1], saliency_runs["jax", "f32"][1]) >= 0.95


def test_saliency_embeddings_equal_embed(saliency_runs, db_and_model, corpus):  # noqa: F811
    """The saliency path's embeddings are embed()'s."""
    cfg, db_dir = db_and_model
    z = Embedder(cfg, os.path.join(db_dir, "model.msgpack"), "cpu").embed(_segments(corpus))
    np.testing.assert_allclose(saliency_runs["port", "bf16"][0], z, rtol=0, atol=1e-6)


def test_png_writer_decodes_to_saliency_image(saliency_runs, tmp_path):
    """The zlib/struct PNG holds exactly saliency_image's pixels (the JAX
    package's function on the same arrays), and PIL reads it."""
    _, tdg, tg = saliency_runs["port", "bf16"]
    img = saliency_image(tdg, tg)
    np.testing.assert_array_equal(img, jax_saliency_image(tdg, tg))
    path = save_saliency_png(str(tmp_path), "/x/y/q.wav", tdg, tg)
    assert path == str(tmp_path / "q.wav.png")
    data = _bytes(path)
    assert data == png_bytes(img) and data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h, depth, kind = struct.unpack(">IIBB", data[16:26])
    assert (w, h, depth, kind) == (img.shape[1], img.shape[0], 8, 2)
    idat = data[33:]
    n = struct.unpack(">I", idat[:4])[0]
    assert idat[4:8] == b"IDAT"
    raw = np.frombuffer(zlib.decompress(idat[8 : 8 + n]), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()
    np.testing.assert_array_equal(raw[:, 1:].reshape(img.shape), img)
    try:
        from PIL import Image
    except ImportError:
        return
    np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), img)


def test_matcher_visualize_writes_pngs(db_and_model, queries, tmp_path):  # noqa: F811
    """matcher --visualize: one PNG per query next to the result file, and
    the same TSV (and .bin answers) as without the flag."""
    _, db_dir = db_and_model
    qlist, _, _ = queries
    viz = tmp_path / "viz"
    _port(matcher, qlist, db_dir, viz / "result.txt", "--visualize")
    _port(matcher, qlist, db_dir, tmp_path / "plain" / "result.txt")
    assert _bytes(viz / "result.txt") == _bytes(tmp_path / "plain" / "result.txt")
    pngs = sorted(p for p in os.listdir(viz) if p.endswith(".png"))
    assert pngs == ["c%d.wav.png" % i for i in range(4)]
    w, h = struct.unpack(">II", _bytes(viz / pngs[0])[16:24])
    assert (h, w) == (256, 5 * 32)
    a = np.fromfile(viz / "result.txt.bin", np.float32)
    b = np.fromfile(tmp_path / "plain" / "result.txt.bin", np.float32)
    np.testing.assert_allclose(a, b, rtol=0, atol=SCORE_ATOL)
