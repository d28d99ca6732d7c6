"""The port's host tools (pfann_tpu_torch/tools/, genquery_naf) against
their JAX twins, byte for byte on the same inputs.

Each JAX tool runs in-process (``run_cli_inproc``), each port tool
through its ``main``.  Outputs that name their own output directory
(list files, a converted model's configs.json) are compared with that
directory's name replaced; a MAT file's 116-byte text header holds its
creation time, so MAT files are compared from byte 116 on.
screen_rank_diag prints the same JSON line (ranks are integers: equal).
"""

import csv
import json
import os
import random
import sys
import types

import numpy as np
import pytest
import torch

from pfann_tpu.audio.io import write_wav
from pfann_tpu.utils import checkpoint as jax_checkpoint
from pfann_tpu_torch import genquery_naf
from pfann_tpu_torch.tools import (
    convert_naf_to_pfann,
    convert_pfann_torch,
    createdataset,
    listaudio,
    make_synth_corpus,
    merge_dbs,
    screen_rank_diag,
    wham,
)
from pfann_tpu_torch.utils.checkpoint import msgpack_restore, save_model
from tests.conftest import run_cli_inproc
from tests.test_convert import make_torch_style_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax(script, *argv, capture=False):
    return run_cli_inproc(os.path.join(REPO, script), [str(a) for a in argv], capture)


def _port(tool, *argv):
    tool.main([tool.__name__, *map(str, argv)])


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _assert_same_tree(jdir, tdir):
    a, b = _tree(jdir), _tree(tdir)
    assert sorted(a) == sorted(b) and a
    for name in a:
        x, y = a[name].replace(jdir.encode(), b"<out>"), b[name].replace(tdir.encode(), b"<out>")
        if name.endswith(".mat"):
            assert x[:19] == y[:19] == b"MATLAB 5.0 MAT-file", name
            x, y = x[116:], y[116:]
        assert x == y, name


# ------------------------------------------------------------- merge_dbs
def _small_db(path, rng, n_songs, d, align_pad=None):
    os.makedirs(path)
    counts = rng.integers(3, 9, size=n_songs).astype(np.int32)
    rng.standard_normal((int(counts.sum()), d)).astype(np.float32).tofile(
        os.path.join(path, "embeddings"))
    counts.tofile(os.path.join(path, "landmarkKey"))
    with open(os.path.join(path, "songList.txt"), "w") as f:
        f.writelines("%s/song%d.wav\n" % (os.path.basename(path), i) for i in range(n_songs))
    meta = {"version": 1, "metric": "inner_product", "d": d, "ntotal": int(counts.sum())}
    if align_pad:
        meta["align_pad"] = align_pad
    with open(os.path.join(path, "index_meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    with open(os.path.join(path, "configs.json"), "w") as f:
        json.dump({"model": {"d": d}}, f)
    with open(os.path.join(path, "model.msgpack"), "wb") as f:
        f.write(rng.bytes(64))
    return counts


def test_merge_dbs_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    srcs = [str(tmp_path / "a"), str(tmp_path / "b")]
    counts = [_small_db(srcs[0], rng, 3, 8, align_pad=48), _small_db(srcs[1], rng, 4, 8, 32)]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _jax("tools/merge_dbs.py", jdir, *srcs)
    _port(merge_dbs, tdir, *srcs)
    _assert_same_tree(jdir, tdir)
    meta = json.load(open(os.path.join(tdir, "index_meta.json")))
    assert meta["ntotal"] == int(sum(c.sum() for c in counts)) and meta["align_pad"] == 48


def test_merge_dbs_refuses_mismatched_dims(tmp_path):
    rng = np.random.default_rng(1)
    _small_db(str(tmp_path / "a"), rng, 2, 8)
    _small_db(str(tmp_path / "b"), rng, 2, 16)
    with pytest.raises(ValueError, match="dim mismatch"):
        merge_dbs.merge_dbs(str(tmp_path / "out"), [str(tmp_path / "a"), str(tmp_path / "b")])


# ------------------------------------------------- convert_pfann_torch
@pytest.fixture(scope="module")
def reference_model(tmp_path_factory):
    """tests/test_convert.py's synthetic reference state dict as a
    model.pt (and as a full checkpoint), with its configs.json."""
    root = tmp_path_factory.mktemp("convert")
    d, h, u = 16, 64, 8
    state = make_torch_style_state(np.random.default_rng(0), d, h, u)
    tensors = {k: torch.from_numpy(v) for k, v in state.items()}
    torch.save(tensors, str(root / "model.pt"))
    torch.save({"model": tensors, "epoch": 3}, str(root / "checkpoint.pt"))
    with open(root / "configs.json", "w") as f:
        json.dump({"model": {"d": d, "h": h, "u": u}}, f)
    return root, state, (d, h, u)


@pytest.mark.parametrize("source", ["model.pt", "checkpoint.pt"])
def test_convert_pfann_torch_matches_jax(reference_model, source):
    root, state, (d, h, u) = reference_model
    jout, tout = str(root / ("jax_" + source)), str(root / ("port_" + source))
    _jax("tools/convert_pfann_torch.py", root / source, root / "configs.json", jout)
    _port(convert_pfann_torch, root / source, root / "configs.json", tout)
    with open(jout, "rb") as f:
        jbytes = f.read()
    with open(tout, "rb") as f:
        tbytes = f.read()
    assert tbytes == jbytes
    # the restored tree is JAX's converted tree, leaf for leaf
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        from convert_pfann_torch import convert_state_dict as jax_convert
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    want = jax_convert(state, d, h, u)
    got = msgpack_restore(tbytes)

    def walk(a, b, path):
        if isinstance(a, dict):
            assert list(b) == sorted(a), path
            for k in a:
                walk(a[k], b[k], path + "/" + k)
        else:
            assert b.dtype == torch.float32, path
            np.testing.assert_array_equal(b.numpy(), a, err_msg=path)

    walk(want, got, "")
    restored = jax_checkpoint.load_model(tout, want)
    assert restored["params"]["g"]["w1"].shape == (d, h // d, u)


# ------------------------------------------------ convert_naf_to_pfann
class _Model(types.SimpleNamespace):
    def __call__(self, x):
        return x


class _Layer:
    def __init__(self, weights, strides=None):
        self.weights, self.strides = weights, strides

    def get_weights(self):
        return self.weights


def _fake_naf(state, d, u):
    """A neural-audio-fp keras model holding ``state`` (reference torch
    layout) in TF layouts, and the ``run`` / ``model.generate`` modules
    the converter imports."""
    convs = []
    for i in range(8):
        p = "f.convs.%d." % i
        conv = types.SimpleNamespace(
            conv2d_1x3=_Layer([state[p + "conv1.weight"].transpose(2, 3, 1, 0),
                               state[p + "conv1.bias"]], strides=(1, 2)),
            BN_1x3=_Layer([state[p + "ln1.weight"].transpose(1, 2, 0),
                           state[p + "ln1.bias"].transpose(1, 2, 0)]),
            conv2d_3x1=_Layer([state[p + "conv2.weight"].transpose(2, 3, 1, 0),
                               state[p + "conv2.bias"]], strides=(2, 1)),
            BN_3x1=_Layer([state[p + "ln2.weight"].transpose(1, 2, 0),
                           state[p + "ln2.bias"].transpose(1, 2, 0)]),
        )
        convs.append(conv)
    convs.append(None)  # the front end's last layer (flatten) is skipped
    w1 = state["g.linear1.weight"][:, :, 0]  # [d*u, v]
    w2 = state["g.linear2.weight"][:, :, 0]  # [d, u]
    fcs = [types.SimpleNamespace(layers=[
        _Layer([w1[g * u : (g + 1) * u].T, state["g.linear1.bias"][g * u : (g + 1) * u]]),
        _Layer([w2[g][:, None], state["g.linear2.bias"][g : g + 1]])]) for g in range(d)]
    m_fp = _Model(front_conv=types.SimpleNamespace(layers=convs),
                  div_enc=types.SimpleNamespace(split_fc_layers=fcs))
    cfg = {"DIR": {"LOG_ROOT_DIR": "logs/"},
           "MODEL": {"DUR": 1, "FS": 8000, "EMB_SZ": d, "STFT_WIN": 1024, "STFT_HOP": 256,
                     "N_MELS": 256, "F_MIN": 300, "F_MAX": 4000, "HOP": 0.5}}
    run = types.ModuleType("run")
    run.load_config = lambda name: cfg
    model = types.ModuleType("model")
    generate = types.ModuleType("model.generate")
    generate.build_fp = lambda c: ((lambda x: x), m_fp)
    generate.load_checkpoint = lambda *a: None
    model.generate = generate
    return {"run": run, "model": model, "model.generate": generate}


def test_convert_naf_to_pfann_matches_jax(reference_model, monkeypatch):
    root, state, (d, h, u) = reference_model
    for name, mod in _fake_naf(state, d, u).items():
        monkeypatch.setitem(sys.modules, name, mod)
    jdir, tdir = str(root / "naf_jax"), str(root / "naf_port")
    _jax("tools/convert_naf_to_pfann.py", "ckpt", "--checkpoint-index", "1", jdir)
    _port(convert_naf_to_pfann, "ckpt", "--checkpoint-index", "1", tdir)
    _assert_same_tree(jdir, tdir)
    cfg = json.load(open(os.path.join(tdir, "configs.json")))
    assert cfg["model"]["h"] == h and cfg["model"]["strides"][0] == [[1, 2], [2, 1]]
    # the same weights as the model.pt route
    direct = save_model(str(root / "naf_direct.msgpack"),
                        convert_pfann_torch.convert_state_dict(state, d, h, u))
    with open(os.path.join(tdir, "model.msgpack"), "rb") as f, open(direct, "rb") as g:
        assert f.read() == g.read()


# ------------------------------------------------------ synthetic data
def test_make_synth_corpus_matches_jax(tmp_path):
    args = ["--train-songs", "1", "--val-songs", "1", "--db-songs", "3", "--test-songs", "1",
            "--seconds", "1.5", "--family-size", "2", "--cover-frac", "0.5", "--seed", "5"]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _jax("tools/make_synth_corpus.py", "--root", jdir, *args)
    _port(make_synth_corpus, "--root", tdir, *args)
    _assert_same_tree(jdir, tdir)
    assert len(os.listdir(os.path.join(tdir, "music"))) == 6


def _gen_cfg(pipeline_root, tmp_path):
    cfg = dict(pipeline_root, test_csv=pipeline_root["train_csv"])
    path = str(tmp_path / "gen.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def test_genquery_naf_matches_jax(pipeline_root, tmp_path):
    cfg_path = _gen_cfg(pipeline_root, tmp_path)
    args = ["-p", cfg_path, "-l", "1", "--num", "2", "--mode", "test", "--yes"]
    jdir, tdir = str(tmp_path / "jq"), str(tmp_path / "tq")
    _jax("genquery_naf.py", *args, "-o", jdir)
    _port(genquery_naf, *args, "-o", tdir)
    _assert_same_tree(jdir, tdir)
    rows = list(csv.reader(open(os.path.join(tdir, "expected.csv"))))
    assert len(rows) == 3 and rows[1][2] == "0.0"


def test_createdataset_matches_jax(pipeline_root, tmp_path):
    cfg_path = _gen_cfg(pipeline_root, tmp_path)
    args = ["-d", pipeline_root["music_dir"], "--noise", pipeline_root["noise"]["dir"],
            "--air", pipeline_root["air"]["dir"], "--micirp", pipeline_root["micirp"]["dir"],
            "-p", cfg_path, "-l", "2"]
    jdir, tdir = str(tmp_path / "jd"), str(tmp_path / "td")
    _jax("denoise/createdataset.py", *args, "-o", jdir)
    _port(createdataset, *args, "-o", tdir)
    _assert_same_tree(jdir, tdir)
    assert len(os.listdir(os.path.join(tdir, "mix"))) == 4


# --------------------------------------------------------- audio lists
@pytest.fixture(scope="module")
def audio_folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("audio")
    rng = np.random.default_rng(2)
    for sub, n, sr in (("a", 2, 8000), ("b/c", 3, 16000)):
        os.makedirs(root / sub)
        for i in range(n):
            write_wav(str(root / sub / ("x%d.wav" % i)),
                      0.3 * rng.standard_normal(sr // 2 + 37 * i).astype(np.float32), sr)
    (root / "a" / "notes.txt").write_text("not audio\n")
    return root


@pytest.mark.parametrize("out", ["list.csv", "list.txt"])
def test_listaudio_matches_jax(audio_folder, tmp_path, out):
    jout, tout = str(tmp_path / ("jax_" + out)), str(tmp_path / ("port_" + out))
    _jax("tools/listaudio.py", "--folder", audio_folder, "--threads", "2", "--out", jout)
    _port(listaudio, "--folder", audio_folder, "--threads", "2", "--out", tout)
    with open(jout, "rb") as f, open(tout, "rb") as g:
        port = g.read()
        assert port == f.read()
    assert port.count(b".wav") == 5


def test_wham_matches_jax(audio_folder, tmp_path):
    wham_dir = tmp_path / "wham"
    for split in ("tr", "cv"):
        os.makedirs(wham_dir / split)
        for i in range(3):
            src = audio_folder / "b" / "c" / ("x%d.wav" % i)
            (wham_dir / split / ("%s%d.wav" % (split, i))).write_bytes(src.read_bytes())
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    state = random.getstate()
    try:
        random.seed(11)
        _jax("tools/wham.py", "--wham", wham_dir, "--audioset", jdir)
        random.seed(11)
        _port(wham, "--wham", wham_dir, "--audioset", tdir)
    finally:
        random.setstate(state)
    _assert_same_tree(jdir, tdir)
    assert sorted(os.listdir(tdir)) == ["cv", "tr"]


# ---------------------------------------------------- screen_rank_diag
@pytest.fixture(scope="module")
def rank_inputs(tmp_path_factory):
    """A 40-song DB (d=16) and 24 noisy 8-row query crops as extractemb
    writes them, with their ground truth (two queries of unknown songs)."""
    root = tmp_path_factory.mktemp("rank")
    rng = np.random.default_rng(4)
    d, n_songs, S = 16, 40, 8
    counts = rng.integers(12, 30, size=n_songs).astype(np.int32)
    emb = rng.standard_normal((int(counts.sum()), d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    db = root / "db"
    os.makedirs(db)
    emb.tofile(str(db / "embeddings"))
    counts.tofile(str(db / "landmarkKey"))
    (db / "songList.txt").write_text("".join("dir/song%02d.wav\n" % i for i in range(n_songs)))
    (db / "index_meta.json").write_text(json.dumps({"d": d, "ntotal": int(counts.sum())}))
    pos = np.pad(np.cumsum(counts), (1, 0))
    qdir = root / "qemb"
    os.makedirs(qdir)
    names, rows, index = [], [], []
    with open(root / "expected.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["query", "answer", "time"])
        for qi in range(24):
            s = int(rng.integers(0, n_songs))
            t = int(rng.integers(0, counts[s] - S + 1))
            q = emb[pos[s] + t : pos[s] + t + S] + 0.3 * rng.standard_normal((S, d))
            index.append((sum(len(r) for r in rows), S))
            rows.append((q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32))
            names.append("q%02d.wav" % qi)
            w.writerow(["q%02d.wav" % qi, "x/song%02d.wav" % (s if qi < 22 else 99), 0])
    np.concatenate(rows).tofile(str(qdir / "query_embeddings"))
    np.asarray(index, np.int64).tofile(str(qdir / "query_index"))
    (qdir / "queryList.txt").write_text("".join(n + "\n" for n in names))
    return str(qdir), str(db), str(root / "expected.csv")


@pytest.mark.parametrize("int8", [False, True])
def test_screen_rank_diag_matches_jax(rank_inputs, capsys, int8):
    qdir, db, expected = rank_inputs
    flags = ["--batch", "16"] + (["--int8"] if int8 else [])
    jline = _jax("tools/screen_rank_diag.py", qdir, db, expected, *flags, capture=True)
    _port(screen_rank_diag, qdir, db, expected, *flags, "--device", "cpu")
    port = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port == json.loads(jline.strip().splitlines()[-1])
    assert port["n"] == 22 and port["skipped"] == 2 and port["int8"] == int8


def test_screen_rank_diag_cuda_without_card_raises(rank_inputs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        _port(screen_rank_diag, *rank_inputs)
