"""``python -m pfann_tpu_torch.genall`` and ``testall``'s argv handling
against ``genall.sh`` and ``testall.sh``.

Both harnesses run in scratch roots that hold the same tiny v2 corpus
(tests/torch_harness_util.py); the JAX side through the shell scripts with
the root CLIs linked in, the port side through its drivers.  genquery is
numpy on the host in both packages, so the two query trees (WAVs,
``expected.csv``, ``list.txt`` of root-relative paths, ``configs.json``)
are byte-equal at 10 s and at 3 s.  An unknown action exits 2 in both.
An unknown dataset exits 2 in the port; ``testall.sh`` prints the same
message from inside ``$(db_list)``, a subshell, so it goes on and exits
1 when the builder fails on the empty list (ROADMAP §3, reference
behaviour 9).
"""

import os

import pytest

from tests import torch_harness_util as hu


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("harness")
    src = str(base / "src")
    hu.make_corpus(src)
    jax_root, port_root = str(base / "jax"), str(base / "port")
    hu.clone(src, jax_root, jax=True)
    hu.clone(src, port_root)
    return jax_root, port_root


@pytest.mark.parametrize("prefix,num,length", [("synth", 2, 10), ("synth3s", 2, 3)])
def test_genall_matches_jax(roots, prefix, num, length):
    jax_root, port_root = roots
    # genquery is a host step: no JAX backend or compile cache to set up
    hu.run_both(["bash", "genall.sh", "gentest_synth", prefix, num, length], jax_root,
                hu.port("genall", "gentest_synth", prefix, num, length), port_root,
                PFANN_COMPILE_CACHE="", PFANN_PLATFORM="")
    for snr in hu.SNRS:
        sub = os.path.join("out", "queries", "%s_snr%d" % (prefix, snr))
        want, got = (hu.tree(os.path.join(r, sub)) for r in roots)
        assert sorted(got) == sorted(want) and len(got) == num + 3, sub
        for name in want:
            assert got[name] == want[name], (sub, name)
        listed = got["list.txt"].decode().split()
        assert len(listed) == num and all(p.startswith(sub + os.sep) for p in listed)
        assert all(os.path.isfile(os.path.join(port_root, p)) for p in listed)


def test_testall_unknown_action_exits_2(roots):
    jax_root, port_root = roots
    jax, port = hu.run_both(["bash", "testall.sh", "synth", "synth", "-bogus"], jax_root,
                            hu.port("testall", "synth", "synth", "-bogus", "--device", "cpu"),
                            port_root, expect=2)
    assert "unknown action -bogus" in jax.stderr
    assert port.stderr.strip() == "unknown action -bogus"


@pytest.mark.parametrize("model", ["synth", "lm"])
def test_testall_unknown_dataset(roots, model):
    jax_root, port_root = roots
    jax = hu.run(["bash", "testall.sh", model, "nosuch", "-build"], jax_root, expect=1)
    port = hu.run(hu.port("testall", model, "nosuch", "-build", "--device", "cpu"),
                  port_root, expect=2)
    assert "nosuch is not a supported dataset" in jax.stderr
    assert port.stderr.strip() == "nosuch is not a supported dataset"
    assert not os.path.exists(os.path.join(port_root, "out", "dbs", model + "_nosuch"))


@pytest.mark.parametrize("argv", [[], ["synth"]])
def test_testall_missing_arguments_exit_1(roots, argv):
    jax_root, port_root = roots
    hu.run(["bash", "testall.sh", *argv], jax_root, expect=1)
    port = hu.run(hu.port("testall", *argv, "--device", "cpu"), port_root, expect=1)
    assert port.stderr.startswith("usage:")
