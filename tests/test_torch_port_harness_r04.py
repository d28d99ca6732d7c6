"""``python -m pfann_tpu_torch.tools.r04_pipeline`` and ``r04_rescue``
(``--jobs 4``: the per-SNR steps four at once) against
``tools/r04_pipeline.sh`` and ``tools/r04_rescue.sh``.

Both sides run in scratch roots (tests/torch_harness_util.py) that share
one DB (``out/dbs/synth_synth``, built by the port), the 10 s query sets,
their embeddings for every SNR but +8 dB (each side extracts that one
itself, so both drivers' extract step runs) and the NN arm's
``synth_synth`` results that ``tools/r04_report.py`` reads.  The variant
DBs' configs are byte-equal; every result is held to JAX's as in
test_torch_port_harness_nn.py (equal lines where JAX's top-1 margin is
clear, on at least half of the queries, times there at most one offset
step apart; every song score within 2e-2);
the accuracy lines are equal up to the unclear queries; the rescued
screen's answers (ids and times) equal the exhaustive control's on every
query; both ``bench --db`` lines carry the same keys (the port's adds
``device``); and both reports are written.
"""

import contextlib
import json
import os

import pytest

from pfann_tpu_torch import builder, extractemb, matcher
from tests import torch_harness_util as hu

NUM = 3
TAGS = ("screenforce", "alignctl")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("harness_r04")
    src = str(base / "src")
    hu.make_corpus(src)
    os.symlink(os.path.join(hu.REPO, "configs"), os.path.join(src, "configs"))
    hu.make_queries(src, "synth", NUM, 10)
    hu.write_model(src)
    db, cpu = "out/dbs/synth_synth", ("--device", "cpu")
    with contextlib.chdir(src), hu.few_threads():
        builder.main(["builder", "out/synth_dataset/lists/db.txt", db, "out/models/synth", *cpu])
        for snr in hu.SNRS[:-1]:
            extractemb.main(["extractemb", "out/queries/synth_snr%d/list.txt" % snr, db,
                             "out/qemb/synth_snr%d" % snr, *cpu])
        pairs = [p for snr in hu.SNRS for p in ("out/queries/synth_snr%d/list.txt" % snr,
                                                 "out/results/synth_synth_snr%d.txt" % snr)]
        matcher.main(["matcher", "--pairs", "--batch", "128", db, *pairs, *cpu])
    roots = {"jax": str(base / "jax"), "port": str(base / "port")}
    hu.clone(src, roots["jax"], jax=True)
    hu.clone(src, roots["port"])
    out = {}
    for name in ("r04_pipeline", "r04_rescue"):
        out[name] = hu.run_both(["bash", "tools/%s.sh" % name], roots["jax"],
                                hu.port("tools." + name, *cpu, "--jobs", 4), roots["port"])
    return roots, out


def _path(root, tag, snr, suffix=".txt"):
    return os.path.join(root, "out", "results", "%s_synth_snr%d%s" % (tag, snr, suffix))


def test_r04_variants_match_jax(runs):
    roots, _ = runs
    for tag in ("alignctl", "screen8", "screenm16", "screeni8", "screenforce", "rescued"):
        rel = os.path.join("out", "dbs", "%s_synth" % tag)
        want = hu.read(os.path.join(roots["jax"], rel, "configs.json"))
        assert hu.read(os.path.join(roots["port"], rel, "configs.json")) == want, tag
        assert os.readlink(os.path.join(roots["port"], rel, "embeddings")) == \
            os.readlink(os.path.join(roots["jax"], rel, "embeddings"))


def test_r04_pipeline_results_match_jax(runs):
    roots, out = runs
    unclear, clear, total = [], 0, 0
    for tag, snrs in [(t, hu.SNRS) for t in TAGS] + [(t, (-6,)) for t in
                                                      ("screen8", "screenm16", "screeni8")]:
        for snr in snrs:
            c, t, shifted = hu.compare_nn(_path(roots["jax"], tag, snr),
                                          _path(roots["port"], tag, snr))
            unclear, clear, total = unclear + [t - c + shifted], clear + c, total + t
    assert clear >= 0.5 * total, (clear, total)
    # accuracy blocks: screenforce, alignctl per SNR, then the tuning variants
    jax, port = out["r04_pipeline"]
    hu.compare_accuracy(jax.stdout, port.stdout, unclear)
    assert os.path.isfile(os.path.join(roots["port"], "out", "qemb", "synth_snr8",
                                       "query_embeddings"))


def test_r04_rescue_matches_jax_and_alignctl(runs):
    roots, out = runs
    unclear = []
    for snr in hu.SNRS:
        c, t, shifted = hu.compare_nn(_path(roots["jax"], "rescued", snr),
                                      _path(roots["port"], "rescued", snr))
        unclear.append(t - c + shifted)
        rescued, control = (hu.rows(_path(roots["port"], tag, snr, "_detail.csv"))
                            for tag in ("rescued", "alignctl"))
        assert [r[:2] + r[3:4] for r in rescued] == [r[:2] + r[3:4] for r in control]
    jax, port = out["r04_rescue"]
    hu.compare_accuracy(jax.stdout, port.stdout, unclear)
    for side in roots.values():
        with open(os.path.join(side, "ACCURACY_r04.md")) as f:
            assert "Screen+rescue vs align" in f.read()


def test_r04_bench_lines_match_jax_keys(runs):
    roots, _ = runs
    for name in ("BENCH_r04_db.json", "BENCH_r04_db_rescued.json"):
        want, got = (json.loads(hu.read(os.path.join(roots[s], name))) for s in ("jax", "port"))
        # the port's bench adds the card string under "device"
        assert sorted(set(got) - {"device"}) == sorted(want), name
        assert got["db"] == want["db"] and got["engine"] == want["engine"]
