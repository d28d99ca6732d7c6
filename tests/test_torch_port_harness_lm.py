"""The landmark arm and the fuse step of the port's harness against the
JAX harness, on the 3 s query sets (``synth3s``, the ensemble's regime).

Scratch roots hold the same corpus (17 songs in families of 8, so that
siblings confuse the landmark arm at low SNR), 16 queries per SNR and one
model (tests/torch_harness_util.py).  Under ``PFANN_LM_DEVICE=0`` both
packages hash on the numpy host path: ``testall lm synth3s -build
-match_snr -accuracy_snr`` writes equal files (DB, TSV, ``.csv``, ``.bin``)
and equal accuracy lines.  With the port's torch extractor on the CPU
(``--device cpu``, no ``PFANN_LM_DEVICE``) the peak gate may flip cells
against numpy (ROADMAP §3, reference behaviour 2): the DB's index triples
agree on at least 95% and at least 90% of the answers are equal.
``ensemble/fuse_synth.py --dataset synth3s`` (the pipeline's step, run by
hand on the JAX side, through ``run_synth_pipeline.fuse`` on the port's)
then reads each side's NN and landmark results: the landmark features
are byte-equal, the NN features' scores within 2e-2 and their correctness
equal wherever JAX's top-1 margin is clear (few are: the families of 8
crowd the NN's scores too; test_torch_port_harness_nn.py holds the NN arm
on clear margins); both print the per-SNR table, with equal landmark
rows.
"""

import os

import numpy as np
import pytest

from pfann_tpu_torch.tools import run_synth_pipeline
from tests import torch_harness_util as hu

CORPUS = ("--train-songs", "2", "--val-songs", "1", "--db-songs", "12", "--test-songs", "2",
          "--seconds", "12", "--family-size", "8")
NUM = 16
LM = ["-build", "-match_snr", "-accuracy_snr"]


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("harness_lm")
    src = str(base / "src")
    hu.make_corpus(src, CORPUS)
    os.symlink(os.path.join(hu.REPO, "configs"), os.path.join(src, "configs"))
    hu.make_queries(src, "synth3s", NUM, 3)
    hu.write_model(src)
    out = {}
    for side in ("jax", "port", "torch"):
        out[side] = str(base / side)
        hu.clone(src, out[side], jax=side == "jax")
    # the three landmark runs at once, then both NN arms at once
    procs = [hu.start(["bash", "testall.sh", "lm", "synth3s", *LM], out["jax"],
                       {"PFANN_LM_DEVICE": "0"}),
             hu.start(hu.port("testall", "lm", "synth3s", *LM, "--device", "cpu"),
                       out["port"], {"PFANN_LM_DEVICE": "0"}),
             hu.start(hu.port("testall", "lm", "synth3s", *LM, "--device", "cpu"),
                       out["torch"], {})]
    out["lm"] = [hu.finish(p, 0).stdout for p in procs]
    nn = ["synth", "synth3s", "-build", "-match_snr"]
    hu.run_both(["bash", "testall.sh", *nn], out["jax"],
                hu.port("testall", *nn, "--device", "cpu"), out["port"])
    return out


def test_testall_lm_numpy_path_matches_jax(roots):
    want, got = (hu.tree(os.path.join(roots[s], "out", "dbs", "lm_synth")) for s in ("jax", "port"))
    assert sorted(got) == ["landmarks.npz", "lm_meta.json", "songList.txt"] == sorted(want)
    assert got == want
    for snr in hu.SNRS:
        stem = os.path.join("out", "results", "lm_synth3s_snr%d.txt" % snr)
        for suffix in ("", ".csv", ".bin"):
            assert hu.read(os.path.join(roots["port"], stem + suffix)) == \
                hu.read(os.path.join(roots["jax"], stem + suffix)), stem + suffix
    jax_out, port_out, _ = roots["lm"]
    hu.compare_accuracy(jax_out, port_out, [0] * len(hu.SNRS))


def test_testall_lm_torch_extractor_agrees(roots):
    """Reference behaviour 2: agreement and answers, not bytes."""
    dbs = [np.load(os.path.join(roots[s], "out", "dbs", "lm_synth", "landmarks.npz"))
           for s in ("jax", "torch")]
    keys = [set(map(tuple, np.stack([d[k] for k in sorted(d.files)
                                     if d[k].ndim == 1 and d[k].size == d[d.files[0]].size],
                                    1).tolist())) for d in dbs]
    assert len(keys[0] & keys[1]) >= 0.95 * max(len(keys[0]), len(keys[1]))
    same = total = 0
    for snr in hu.SNRS:
        rel = os.path.join("out", "results", "lm_synth3s_snr%d.txt" % snr)
        a, b = (hu.read(os.path.join(roots[s], rel)).splitlines() for s in ("jax", "torch"))
        assert len(a) == len(b) == NUM
        same, total = same + sum(x == y for x, y in zip(a, b)), total + len(a)
    assert same >= 0.9 * total, (same, total)


def test_fuse_matches_jax(roots, capfd):
    jax_root, port_root = roots["jax"], roots["port"]
    with open(os.path.join(hu.REPO, "tools", "run_synth_pipeline.sh")) as f:
        line = next(x for x in f if x.startswith("python ensemble/fuse_synth.py"))
    jax = hu.start(["bash", "-e", "-c", line], jax_root, {})
    capfd.readouterr()
    run_synth_pipeline.stage(port_root)
    with hu.few_threads():
        run_synth_pipeline.fuse(port_root)
    port_out = capfd.readouterr().out
    jax_out = hu.finish(jax, 0).stdout
    fuse = os.path.join("out", "ensemble3s")
    for snr in hu.SNRS:
        lm = "lm_snr%d.npy" % snr
        assert hu.read(os.path.join(port_root, fuse, lm)) == hu.read(os.path.join(jax_root, fuse, lm))
        jn, pn = (np.load(os.path.join(r, fuse, "nn_snr%d.npy" % snr)) for r in (jax_root, port_root))
        clear = hu.margins(os.path.join(jax_root, "out", "results",
                                        "synth_synth3s_snr%d.txt" % snr), NUM) >= hu.MARGIN_TOL
        np.testing.assert_array_equal(pn[clear, 1], jn[clear, 1])
        np.testing.assert_allclose(pn[:, 0], jn[:, 0], rtol=0, atol=hu.SCORE_ATOL)
    table = [[x for x in out.splitlines() if x.startswith("| ")] for out in (jax_out, port_out)]
    assert len(table[0]) == len(table[1]) == 4
    assert table[0][0] == table[1][0] and table[0][2] == table[1][2]  # SNRs, landmark row
    assert "best linear fuser on pooled eval" in port_out and "step fuse " in port_out
