"""The NN arm of the port's harness against the JAX harness:
``testall synth synth|synth3s -build -match_snr -accuracy_snr`` and the
``frame_shift_mul`` sweep of ``tools/run_synth_pipeline.sh``.

Both sides run in scratch roots with the same tiny corpus, query sets and
model bytes (tests/torch_harness_util.py); the JAX side through
``testall.sh`` and the sweep's own lines of ``run_synth_pipeline.sh`` (cut
from the script and run by hand), the port side through ``python -m
pfann_tpu_torch.testall --device cpu`` and ``run_synth_pipeline.fsm_sweep``.
The DB files equal JAX's (embeddings within 2e-2: both embed in bf16);
result lines, ids and times are equal wherever JAX's top-1 margin clears
``MARGIN_TOL``, on at least half of the queries (every song score within
2e-2);
accuracy lines are equal, or differ by at most the set's count of queries
under the margin.
"""

import os

import numpy as np
import pytest

from pfann_tpu_torch.tools import run_synth_pipeline
from tests import torch_harness_util as hu

NUM = {"synth": 3, "synth3s": 4}


def sweep_lines(fsms):
    """The fsm sweep of tools/run_synth_pipeline.sh (its ``for fsm in``
    loop), with the fsm list replaced."""
    with open(os.path.join(hu.REPO, "tools", "run_synth_pipeline.sh")) as f:
        text = f.read()
    start = text.index("for fsm in 2 4; do")
    end = text.index("echo PIPELINE_DONE")
    return text[start:end].replace("for fsm in 2 4;", "for fsm in %s;" % " ".join(map(str, fsms)))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("harness_nn")
    src = str(base / "src")
    hu.make_corpus(src)
    os.symlink(os.path.join(hu.REPO, "configs"), os.path.join(src, "configs"))
    hu.make_queries(src, "synth", NUM["synth"], 10)
    hu.make_queries(src, "synth3s", NUM["synth3s"], 3)
    hu.write_model(src)
    jax_root, port_root = str(base / "jax"), str(base / "port")
    hu.clone(src, jax_root, jax=True)
    hu.clone(src, port_root)
    return jax_root, port_root


@pytest.fixture(scope="module")
def testall_runs(roots):
    """testall's NN arm on synth (with -build) and synth3s, both sides;
    {dataset: (jax stdout, port stdout)}."""
    jax_root, port_root = roots
    out = {}
    for dataset, actions in (("synth", ["-build"]), ("synth3s", [])):
        actions = actions + ["-match_snr", "-accuracy_snr"]
        jax, port = hu.run_both(["bash", "testall.sh", "synth", dataset, *actions], jax_root,
                                hu.port("testall", "synth", dataset, *actions, "--device", "cpu"),
                                port_root)
        out[dataset] = (jax.stdout, port.stdout)
    return out


def test_testall_build_matches_jax(roots, testall_runs):
    jdb, pdb = (os.path.join(r, "out", "dbs", "synth_synth") for r in roots)
    for name in ("landmarkKey", "songList.txt", "configs.json", "model.msgpack",
                 "index_meta.json"):
        assert hu.read(os.path.join(pdb, name)) == hu.read(os.path.join(jdb, name)), name
    je, pe = (np.fromfile(os.path.join(d, "embeddings"), np.float32) for d in (jdb, pdb))
    assert je.shape == pe.shape and je.size == 5 * 23 * 64
    np.testing.assert_allclose(pe, je, rtol=0, atol=hu.SCORE_ATOL)


def _hold(roots, tag, step=0.5):
    """Each SNR's result held to JAX's; the per-SNR slack of the accuracy
    counts (queries under the margin, or one offset step apart)."""
    jax_root, port_root = roots
    clear = total = 0
    slack = []
    for snr in hu.SNRS:
        rel = os.path.join("out", "results", "%s_snr%d.txt" % (tag, snr))
        c, t, shifted = hu.compare_nn(os.path.join(jax_root, rel),
                                      os.path.join(port_root, rel), step)
        clear, total, slack = clear + c, total + t, slack + [t - c + shifted]
    assert clear >= 0.5 * total, (clear, total)
    return slack


@pytest.mark.parametrize("dataset", ["synth", "synth3s"])
def test_testall_match_and_accuracy_match_jax(roots, testall_runs, dataset):
    hu.compare_accuracy(*testall_runs[dataset], _hold(roots, "synth_" + dataset))


def test_fsm_sweep_matches_jax(roots, testall_runs, capfd):
    jax_root, port_root = roots
    fsms = [2, 4]
    capfd.readouterr()
    with hu.few_threads():
        run_synth_pipeline.fsm_sweep(port_root, fsms, "cpu")
    port_out = capfd.readouterr().out
    jax_out = hu.run(["bash", "-e", "-c", sweep_lines(fsms)], jax_root).stdout
    for fsm in fsms:
        db = os.path.join("out", "dbs", "fsm%d_synth" % fsm)
        assert hu.read(os.path.join(port_root, db, "configs.json")) == \
            hu.read(os.path.join(jax_root, db, "configs.json"))
        assert os.readlink(os.path.join(port_root, db, "embeddings")) == \
            os.readlink(os.path.join(jax_root, db, "embeddings"))
    slack = []
    for fsm in fsms:
        slack += _hold(roots, "fsm%d_synth" % fsm, 0.5 / fsm)
    hu.compare_accuracy(jax_out, port_out, slack)
    assert "step matcher fsm2 " in port_out
