"""The benchmark's harness on the CPU at tiny sizes: generators, the run
loop and its last line, the comparison and its control, the faults it has
to catch, the import guard, and ``BENCHMARK.json`` against the files it
names.  The cells themselves run only on the card."""

import ast
import json
import os
import re
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from fpbench import generate, run
from fpbench.reference import fpnet, search

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FP = os.path.join(ROOT, "fpbench")
DATA = os.path.join(FP, "tests", "data")
CPU = torch.device("cpu")
# tiny-d16 on the CPU: the program reads answer_err 1.0e-3 (rows) to 1.7e-3
# (audio) on these seeds, the fp8 control 9.2e-3 to 3.3e-2
TINY_LIMIT = 5e-3
SEED = 2**31 + 17  # seeds run past 32 signed bits


def load(name):
    with open(os.path.join(DATA, name + ".json")) as f:
        return json.load(f)


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def tiny_cell(traffic, config="tiny-d16"):
    b = bench()
    return run.Cell(name="tiny", chips=1, config=load(config), traffic=load(traffic),
                    limits={"answer_err": TINY_LIMIT}, end_to_end=b["end_to_end"],
                    per_layer=b["per_layer"])


def tiny_run(cell, trace=False, seconds=0.5, control=False, seed=SEED):
    return run.run_cell(cell, seed, seconds, trace, CPU, time.time(), control=control)


@pytest.mark.parametrize("traffic", ["tiny-audio", "tiny-rows"])
def test_same_seed_same_inputs(traffic):
    cfg, tr = load("tiny-d16"), load(traffic)
    a = generate.make_inputs(cfg, tr, SEED, CPU)
    b = generate.make_inputs(cfg, tr, SEED, CPU)
    c = generate.make_inputs(cfg, tr, SEED + 1, CPU)
    for x, y in ((a.pool, b.pool), (a.catalogue, b.catalogue), (a.order, b.order),
                 (a.truth, b.truth), (a.check, b.check)):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a.pool, c.pool)
    assert not np.array_equal(a.catalogue, c.catalogue)
    assert a.pool.shape == c.pool.shape and a.catalogue.shape == c.catalogue.shape
    if tr["kind"] == "audio":
        assert a.pool.dtype == np.int16
        assert a.pool.shape[1] == generate.song_samples(cfg, tr["query_rows"])
        for k in a.params:
            torch.testing.assert_close(a.params[k], b.params[k], rtol=0, atol=0)
    else:
        np.testing.assert_allclose(np.linalg.norm(a.pool, axis=2), 1.0, rtol=1e-5)


@pytest.mark.parametrize("traffic", ["tiny-audio", "tiny-rows"])
def test_traffic_grid_is_the_same_for_every_seed(traffic):
    """Each seed sends the same SNRs, or the same cosines with the same number
    under the rescue gate, in another order."""
    tr = load(traffic)
    dev = CPU

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        if tr["kind"] == "audio":
            return generate.on_grid(tr["snr_db"], tr["pool"], g, dev)
        return generate.query_cosines(tr, tr["pool"], g, dev)

    a, b = draw(SEED), draw(SEED + 1)
    assert not torch.equal(a, b)
    torch.testing.assert_close(a.sort().values, b.sort().values, rtol=0, atol=0)
    if tr["kind"] == "audio":
        counts = torch.unique(a, return_counts=True)[1]
        assert len(counts) == len(tr["snr_db"]) and counts.max() - counts.min() <= 1
    else:
        M = generate.escalated_count(tr, tr["pool"])
        assert M == round(tr["pool"] * sum(tr["escalated"]) / len(tr["escalated"]))
        lo, hi = tr["cosine_escalate"]
        grid = lo + (hi - lo) * (torch.arange(M) + 0.5) / M
        torch.testing.assert_close(a.sort().values[:M], grid)
        assert float(a.sort().values[M]) >= tr["cosine_pass"][0]
        assert float(a.max()) <= tr["cosine_pass"][1]


def last_json_line(text):
    line = [ln for ln in text.splitlines() if ln.strip()][-1]
    return json.loads(line)


@pytest.mark.parametrize("traffic,trace", [("tiny-audio", False), ("tiny-audio", True),
                                           ("tiny-rows", False), ("tiny-rows", True)])
def test_last_line(traffic, trace, capsys):
    cell = tiny_cell(traffic)
    run.emit(tiny_run(cell, trace=trace))
    cap = capsys.readouterr()
    out = last_json_line(cap.out)
    assert list(out)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in out
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["checks"]) == {"failed", "answer_err"}
    for name, c in out["checks"].items():
        assert set(c) == {"value", "limit"}
    err_tail = cap.err.strip().splitlines()[-2:]
    assert [ln.split()[1] for ln in err_tail] == list(out["checks"])
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    wanted = {m["name"]: m for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(out["metrics"]) <= set(wanted)
    for name, m in out["metrics"].items():
        assert m["unit"] == wanted[name]["unit"] and np.isfinite(m["value"])
    if trace:
        assert dev["window_s"] > 0 and "breakdown" in out
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "search_ms" in out["metrics"]
        assert ("embed_ms" in out["metrics"]) == (traffic == "tiny-audio")
        # the program's spans: host times read here, device times only
        # where a card ran the window
        assert "search_filters_ms" in out["metrics"]
        assert not set(out["metrics"]) & set(DEVICE_ONLY)
    else:
        assert {"queries_per_s", "batch_p95_ms", "setup_s"} == set(out["metrics"])


def test_screen_run():
    # 30,000 songs: the auto path's screen; d=32 and 19-row queries keep the
    # random rows' best alignments (~0.2) under the rescue gate, as at d=64
    out = tiny_run(tiny_cell("tiny-rows19", config="tiny-d32-30k"), seconds=1.0)
    assert out["info"]["engine"] == "screen"
    assert out["info"]["escalated"] is not None
    assert out["correct"] is True


def alter_answers(monkeypatch):
    from pfann_tpu_torch.index.database import Database

    real = Database.query_top1_batch

    def altered(self, queries):
        return [(s, ((song + 1) % len(self.songList), t)) for s, (song, t) in real(self, queries)]

    monkeypatch.setattr(Database, "query_top1_batch", altered)


def drop_half(monkeypatch):
    from pfann_tpu_torch.index.database import Database

    real = Database.query_top1_batch
    monkeypatch.setattr(Database, "query_top1_batch",
                        lambda self, q: real(self, q[: len(q) // 2]))


def shift_embeddings(monkeypatch):
    from pfann_tpu_torch.index.embedder import Embedder

    real = Embedder.embed_songs
    monkeypatch.setattr(Embedder, "embed_songs",
                        lambda self, *a: [np.roll(z, 1, axis=0) for z in real(self, *a)])


@pytest.mark.parametrize("fault,traffic", [
    (alter_answers, "tiny-rows"), (alter_answers, "tiny-audio"),
    (drop_half, "tiny-rows"), (drop_half, "tiny-audio"),
    (shift_embeddings, "tiny-audio")])
def test_fault_is_caught(fault, traffic, monkeypatch):
    """The timed path broken underneath: ``correct`` comes out false."""
    fault(monkeypatch)
    out = tiny_run(tiny_cell(traffic))
    assert out["correct"] is False
    assert out["failed"] > 0 or out["checks"]["answer_err"]["value"] > TINY_LIMIT


@pytest.mark.parametrize("traffic", ["tiny-audio", "tiny-rows"])
def test_control_fails(traffic):
    """The reference at fp8 in the program's place comes out not correct by
    the predicate and the limit that the program passes."""
    out = tiny_run(tiny_cell(traffic), control=True)
    assert out["correct"] is True
    control = out["info"]["control"]
    assert control["correct"] is False
    assert control["failed"] == 0 and control["answer_err"] > TINY_LIMIT


@pytest.mark.parametrize("config", ["tiny-d16", "nafp-d128-cat10k", "pfann-d64-cat100k"])
def test_reference_encoder_is_the_program_in_f32(config):
    from pfann_tpu_torch.models.fp_network import build_fp_network
    from pfann_tpu_torch.ops.melspec import build_mel_spec_layer

    path = os.path.join(DATA if config.startswith("tiny") else os.path.join(FP, "configs"),
                        config + ".json")
    with open(path) as f:
        cfg = json.load(f)
    params = generate.draw_weights(cfg, torch.Generator().manual_seed(3), CPU)
    model = build_fp_network(cfg)
    model.load_state_dict(params)
    audio = generate.synth_songs(1, generate.song_samples(cfg, 4), cfg, load("tiny-audio"),
                                 torch.Generator().manual_seed(4), CPU)
    seg = fpnet.segments(audio, cfg)[0]
    with torch.no_grad():
        mel_port = build_mel_spec_layer(cfg)(seg)
        mel_ref = fpnet.log_mel(seg, cfg, fpnet.mel_filterbank(cfg))
        torch.testing.assert_close(mel_ref, mel_port, rtol=1e-4, atol=2e-4)
        z_port = model(mel_ref, norm=True)
        z_ref = fpnet.encode(mel_ref, params, cfg)
    torch.testing.assert_close(z_ref, z_port, rtol=1e-4, atol=1e-5)


def test_reference_search_is_brute_force():
    g = torch.Generator().manual_seed(5)
    db = torch.randn(7, 9, 4, generator=g)
    q = torch.randn(3, 4, 4, generator=g)
    n, C, _ = db.shape
    S = q.shape[1]
    brute = np.full((3, n, C + S - 1), 0.0)
    for k in range(3):
        for s in range(n):
            for t in range(-(S - 1), C):
                brute[k, s, t + S - 1] = sum(float(db[s, t + i] @ q[k, i])
                                             for i in range(S) if 0 <= t + i < C) / S
    score, song, t = search.best_alignment(db, q, song_block=3, query_block=2)
    for k in range(3):
        assert float(score[k]) == pytest.approx(brute[k].max(), abs=1e-5)
        assert brute[k, int(song[k]), int(t[k]) + S - 1] == pytest.approx(brute[k].max(), abs=1e-5)
    ss = torch.tensor([0, 6, 2, 9]), torch.tensor([-3, 8, -5, 0])
    got = search.score_at(db, q[[0, 1, 2, 2]], *ss)
    want = [brute[0, 0, 0], brute[1, 6, 8 + S - 1], 0.0, 0.0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)




def imports_of(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out, {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}


def test_import_guard():
    """No file of the benchmark imports JAX, the JAX package or the root
    bench.py (top-level names compared whole: ``pfann_tpu_torch`` is not
    ``pfann_tpu``); the reference imports nothing of the program; the harness
    takes nothing of the program's own benchmark or smoke test."""
    files = [os.path.join(dp, f) for dp, _, fs in os.walk(FP) for f in fs if f.endswith(".py")]
    assert files
    for path in files:
        top, modules = imports_of(path)
        assert not top & {"jax", "jaxlib", "flax", "pfann_tpu", "bench", "chip_smoke"}, path
        assert "pfann_tpu_torch.bench" not in modules, path
        if os.sep + "reference" + os.sep in path:
            assert "pfann_tpu_torch" not in top, path


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pfann_tpu_torch_probe", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    monkeypatch.setitem(sys.modules, "pfann_tpu.index", types.ModuleType("pfann_tpu.index"))
    assert run.forbidden_modules() == ["jax", "pfann_tpu"]


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: this checks the refusal without one")
    rc = run.main(["--workload", "d128-10k-audio", "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert not capsys.readouterr().out.strip()


def test_benchmark_alone_fails(tmp_path):
    """A checkout holding only BENCHMARK.json and fpbench/ has no program to
    measure: the run exits non-zero and prints no result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(FP, tmp_path / "fpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "fpbench.run", "--workload", "d128-10k-audio",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": ""})
    assert p.returncode != 0
    assert "{" not in p.stdout


# per-layer metrics that only the card's trace gives
DEVICE_ONLY = ("encoder_ms", "melspec_ms", "stage3_ms", "stage3_roofline",
               "host_prep_idle_pct", "device_idle_pct", "align_reduce_roofline",
               "serve_mfu")

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_names_its_files():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["fpbench"] and 1 <= b["run_seconds"] <= 51
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert body["source"] == c["source"]
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(FP, "metrics", m["name"] + ".py")), m["name"]
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    used = set()
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
        assert w["config"] in configs
        used.add(w["config"])
        assert os.path.exists(os.path.join(FP, "traffic", w["traffic"] + ".json"))
        with open(os.path.join(FP, "workloads", w["name"] + ".json")) as f:
            assert "answer_err" in json.load(f)["limits"]
        reported, layer = run.metrics_of(b, w["name"])
        names = {m["name"] for m in reported}
        assert "setup_s" in names and len(names) >= 2 and layer
    assert used == set(configs)
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        # a list, so that a cell added later does not have to report it
        assert m.get("workloads") and set(m["workloads"]) <= cells, m["name"]


@pytest.mark.cuda
@pytest.mark.parametrize("traffic,config,like", [
    ("tiny-rows", "tiny-d16", None),
    ("tiny-audio", "tiny-d16", "d128-10k-audio"),
    ("tiny-rows19", "tiny-d32-30k", "d64-100k-emb-noisy")])
def test_tiny_run_on_the_card(traffic, config, like):
    """A traced run on the card: every per-layer metric that the cell it
    stands for lists is in the line, no program span reads as device work,
    and nearly all device time lies under a program span."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = run.run_cell(tiny_cell(traffic, config), SEED, 1.0, True, torch.device("cuda", 0),
                       time.time())
    assert out["correct"] is True
    assert out["device"]["busy_s"] > 0
    info = out["info"]
    spans = info["program_spans"]
    assert not set(spans) & {n for n, _ in out["breakdown"]["device_ops"]}
    device_s = sum(s["device_s"] for s in spans.values())
    assert info["program_unattributed_s"] <= 0.01 * (device_s + info["program_unattributed_s"])
    if like is not None:
        listed = {m["name"] for m in run.metrics_of(bench(), like)[1]}
        assert listed <= set(out["metrics"])
    for name, m in out["metrics"].items():
        assert np.isfinite(m["value"]), name
        if name.endswith("_roofline") or "mfu" in name:
            assert 0 < m["value"] <= 100, name
