"""Shared set-up of the evaluation-harness parity tests
(``tests/test_torch_port_harness*.py``).

A harness root is a scratch working directory laid out as the repository
is: ``out/synth_dataset`` (a tiny v2 corpus from the port's
``make_synth_corpus``), ``out/models/synth`` (one model at
``configs/synth.json``'s widths), and for the JAX side symlinks to the
root CLIs, ``configs/``, ``tools/`` and ``ensemble/``, so that
``genall.sh``, ``testall.sh`` and ``tools/*.sh`` run there unchanged.  The
JAX side and the port side each get their own root with the same bytes
under ``out/``, and the outputs that name paths name them relative to the
root, so the two sides' files compare byte for byte.

The model is ``init_like_flax`` at the synth widths, then 20 Adam steps of
NT-Xent on pairs of a DB song's 1 s crop and the same crop through the
query synthesis (noise at -6 to 8 dB, room and mic reverb; the corpus'
train split).
A random-init model maps every segment to nearly one embedding (cosine
~0.97 across songs), so its top-1 margins sit inside the bf16 rounding
that the two packages do differently (ROADMAP §3, reference behaviour
3); the short training opens most margins to several hundredths.

Where both packages embed the queries, scores agree within
``SCORE_ATOL`` (test_torch_port_slice.py); a top-1 answer can then differ
only where JAX's margin (best minus second song score in its ``.bin``) is
under ``MARGIN_TOL = 2 * SCORE_ATOL``.  Result lines are compared exactly
wherever JAX's margin is at least that; ``compare_nn`` returns on how
many, and the tests hold that count to a floor.  A time there may be one
offset step off (a near tie of two neighbouring offsets of the winner),
and the accuracy counts may differ by as many.
"""

from __future__ import annotations

import contextlib
import csv
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNRS = (-6, -4, -2, 0, 2, 4, 6, 8)
SCORE_ATOL = 2e-2
MARGIN_TOL = 2 * SCORE_ATOL
JAX_LINKS = ("genquery.py", "builder.py", "matcher.py", "lm_builder.py", "lm_matcher.py",
             "extractemb.py", "matchemb.py", "bench.py", "genall.sh", "testall.sh",
             "configs", "tools", "ensemble")
CORPUS = ("--train-songs", "2", "--val-songs", "1", "--db-songs", "3", "--test-songs", "2",
          "--seconds", "12", "--family-size", "2")


# One thread a child process: the tests run a JAX step and its port step
# at once, drivers start several steps at once, and the suite runs six
# files at once; multi-threaded torch and XLA processes oversubscribe the
# cores and spin, which made these files 5-8x slower in the suite.
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}


# Compiled bytecode of the children's imports, shared by every child: where
# the environment forbids writing it beside the sources
# (PYTHONDONTWRITEBYTECODE), each child would compile scipy, torch and jax
# from source again, seconds a process.
PYCACHE = os.path.join(tempfile.gettempdir(), "pfann_harness_pycache")


def env(**extra: str) -> dict[str, str]:
    """The children's environment: the repository on the path, JAX on
    the CPU, one thread each, bytecode cached under ``PYCACHE``."""
    flags = os.environ.get("XLA_FLAGS", "")
    out = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", **ONE_THREAD,
               XLA_FLAGS=(flags + " --xla_cpu_multi_thread_eigen=false").strip(),
               PYTHONPYCACHEPREFIX=PYCACHE)
    out.pop("PYTHONDONTWRITEBYTECODE", None)
    out.update(extra)
    return out


@contextlib.contextmanager
def few_threads(n: int = 2):
    """This process's torch on ``n`` threads, and the children that
    in-process drivers start on one (``ONE_THREAD``), for the block."""
    import torch

    old, saved = torch.get_num_threads(), {k: os.environ.get(k) for k in ONE_THREAD}
    torch.set_num_threads(n)
    os.environ.update(ONE_THREAD)
    try:
        yield
    finally:
        torch.set_num_threads(old)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def start(cmd: list, cwd: str, extra: dict) -> subprocess.Popen:
    return subprocess.Popen([str(c) for c in cmd], cwd=cwd, env=env(**extra),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish(proc: subprocess.Popen, expect: int) -> subprocess.CompletedProcess:
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == expect, (proc.args, proc.returncode, out[-3000:], err[-3000:])
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def run(cmd: list, cwd: str, expect: int = 0, **extra: str) -> subprocess.CompletedProcess:
    return finish(start(cmd, cwd, extra), expect)


def run_both(jax_cmd: list, jax_root: str, port_cmd: list, port_root: str,
             expect: int = 0, **extra: str):
    """The JAX step and the port step at once (each in its own root);
    their CompletedProcesses."""
    procs = [start(jax_cmd, jax_root, extra), start(port_cmd, port_root, extra)]
    return tuple(finish(p, expect) for p in procs)


def port(cli: str, *args) -> list[str]:
    return [sys.executable, "-m", "pfann_tpu_torch." + cli, *map(str, args)]


def make_corpus(root: str, flags: tuple[str, ...] = CORPUS) -> None:
    from pfann_tpu_torch.tools import make_synth_corpus

    os.makedirs(root, exist_ok=True)
    with contextlib.chdir(root):
        make_synth_corpus.main(["make_synth_corpus", *flags])


def make_queries(root: str, prefix: str, num: int, length: float) -> None:
    """The query sets of ``genall gentest_synth <prefix> <num> <length>``,
    made in this process by the port's genquery (genall's own parity is
    test_torch_port_harness.py's)."""
    from pfann_tpu_torch import genquery

    with contextlib.chdir(root):
        for snr in SNRS:
            genquery.main(["genquery", "--params", "configs/gentest_synth_snr%d.json" % snr,
                           "--length", str(length), "--num", str(num), "--mode", "test",
                           "--out", "out/queries/%s_snr%d" % (prefix, snr), "--yes"])


def write_model(root: str, steps: int = 20, rows: int = 32) -> None:
    """``out/models/synth``: configs.json and model.msgpack (see the
    module docstring)."""
    import torch

    from pfann_tpu_torch.audio.io import get_audio
    from pfann_tpu_torch.data.querygen import (
        ClipSampler, ReverbBank, fft_block_len, load_eval_corpora, synthesize_query)
    from pfann_tpu_torch.models.fp_network import build_fp_network, init_like_flax
    from pfann_tpu_torch.ops.melspec import build_mel_spec_layer
    from pfann_tpu_torch.train.loss import similarity_loss
    from pfann_tpu_torch.utils.checkpoint import save_model

    with open(os.path.join(REPO, "configs", "synth.json")) as f:
        cfg = json.load(f)
    model_dir = os.path.join(root, "out", "models", "synth")
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "configs.json"), "w") as f:
        json.dump(cfg, f, indent=2)
    rng = np.random.default_rng(0)
    with contextlib.chdir(root):
        with open("out/synth_dataset/lists/db.txt") as f:
            songs = [line.strip() for line in f if line.strip()]
        n_fft = fft_block_len(cfg, 1.0)
        noise, air, mic = load_eval_corpora(cfg, "train", n_fft)
        reverb, sampler = ReverbBank(air, mic, n_fft), ClipSampler(8000, 1.0, 0.0)
        clean, noisy = [], []
        for _ in range(steps * rows):
            path = songs[rng.integers(len(songs))]
            audio, t0, _, _ = synthesize_query(rng, path, sampler, noise, reverb, (-6, 8))
            at = int(round(t0 * 8000))
            clean.append(get_audio(path)[0].mean(axis=0)[at : at + 8000])
            noisy.append(audio)
    pairs = np.stack([np.stack(clean), np.stack(noisy)], 1).astype(np.float32)
    pairs -= pairs.mean(axis=2, keepdims=True)
    with torch.no_grad():
        mel = build_mel_spec_layer(cfg)(torch.from_numpy(pairs.reshape(-1, 8000)))
    model = build_fp_network(cfg)
    init_like_flax(model, torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), 1e-3)
    with few_threads():
        for step in range(steps):
            batch = mel[2 * rows * step : 2 * rows * (step + 1)]
            loss = similarity_loss(model(batch), cfg["tau"])
            opt.zero_grad()
            loss.backward()
            opt.step()
    save_model(model_dir, model.state_dict())


def clone(src: str, dst: str, jax: bool = False) -> None:
    """A second root with the bytes of ``src``'s ``out/``; ``configs/``
    (and for the JAX side every link of ``JAX_LINKS``) point at the
    repository."""
    shutil.copytree(os.path.join(src, "out"), os.path.join(dst, "out"), symlinks=True)
    for name in JAX_LINKS if jax else ("configs",):
        os.symlink(os.path.join(REPO, name), os.path.join(dst, name))


def tree(root: str) -> dict[str, bytes]:
    """{relative path: bytes} of every file under root."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def rows(path: str) -> list[list[str]]:
    with open(path) as f:
        return list(csv.reader(f))


def margins(result: str, n_queries: int) -> np.ndarray:
    """Top-1 minus second song score of each query, from a ``.bin``
    ([n_queries, n_songs, 2] float32: score, time)."""
    scores = np.fromfile(result + ".bin", np.float32).reshape(n_queries, -1, 2)[:, :, 0]
    top = np.sort(scores, axis=1)
    return top[:, -1] - top[:, -2]


def compare_nn(jax_result: str, port_result: str, step: float = 0.5) -> tuple[int, int, int]:
    """Hold a port NN result (TSV, _detail.csv, .bin) to JAX's: every
    song score within ``SCORE_ATOL``; equal lines and ids wherever JAX's
    song margin is clear, and there times equal or one offset ``step``
    apart (the ``.bin`` keeps each song's best offset only, so a near tie
    between two neighbouring offsets of the winner cannot be told from
    it).  Returns (clear, total, clear queries one step apart)."""
    jl, pl = read(jax_result).splitlines(), read(port_result).splitlines()
    assert len(jl) == len(pl) > 0
    clear = margins(jax_result, len(jl)) >= MARGIN_TOL
    js, ps = (np.fromfile(r + ".bin", np.float32).reshape(len(jl), -1, 2)[:, :, 0]
              for r in (jax_result, port_result))
    np.testing.assert_allclose(ps, js, rtol=0, atol=SCORE_ATOL)
    jd = rows(os.path.splitext(jax_result)[0] + "_detail.csv")
    pd = rows(os.path.splitext(port_result)[0] + "_detail.csv")
    assert jd[0] == pd[0] and len(jd) == len(pd) == len(jl) + 1
    shifted = 0
    for ok, a, b, x, y in zip(clear, jl, pl, jd[1:], pd[1:]):
        assert x[0] == y[0]
        if ok:
            dt = abs(float(x[3]) - float(y[3]))
            assert a == b and x[1] == y[1] and dt <= step + 1e-6, (a, b, x, y)
            shifted += dt > 0
    return int(clear.sum()), len(jl), shifted


def accuracy_blocks(stdout: str) -> list[tuple[str, list[str]]]:
    """``tools/accuracy.py``'s three lines per result, each with the label
    line the driver printed before it (``snr=..``, ``fsm=.. snr=..``,
    ``model=.. snr=..``, ``set=.. snr=..``, ``cover_sub=.. snr=..``; empty
    where it prints none)."""
    blocks, label = [], ""
    for line in stdout.splitlines():
        if line.startswith(("snr=", "fsm=", "model=", "set=", "cover_sub=")):
            label = line
        elif line.startswith("exact match"):
            blocks.append((label, [line]))
            label = ""
        elif line.startswith(("near match", "song correct")):
            blocks[-1][1].append(line)
    return blocks


def compare_accuracy(jax_out: str, port_out: str, slack: list[int]) -> None:
    """Accuracy blocks equal, except that block i's counts may differ by
    ``slack[i]`` (its queries under the margin or one offset step off)."""
    a, b = accuracy_blocks(jax_out), accuracy_blocks(port_out)
    assert len(a) == len(b) == len(slack) > 0
    for (la, xa), (lb, xb), n in zip(a, b, slack):
        assert la == lb and len(xa) == len(xb) == 3
        for x, y in zip(xa, xb):
            if not n:
                assert x == y, (la, x, y)
            else:
                assert x.split()[:-3] == y.split()[:-3]
                assert abs(int(x.split()[-3]) - int(y.split()[-3])) <= n, (la, x, y)


# The port CLIs' names in the scripts' words (``python -m
# pfann_tpu_torch.<cli>`` for ``python <script>``).
SCRIPT_OF = {"tools.make_synth_corpus": "tools/make_synth_corpus.py", "builder": "builder.py",
             "tools.merge_dbs": "tools/merge_dbs.py", "matchemb": "matchemb.py",
             "matcher": "matcher.py", "genquery": "genquery.py", "bench": "bench.py"}

# bash functions that stand for ``python`` and ``cat`` in a script: each
# call appends its argv as one tab-separated line to $LOG (``python``'s
# first field the environment variables the scripts set on one command)
_RECORDER = r"""
python() {
  { printf 'python\t%s' "${BENCH_SCREEN_DTYPE:+BENCH_SCREEN_DTYPE=$BENCH_SCREEN_DTYPE}"
    for a in "$@"; do printf '\t%s' "$a"; done; printf '\n'; } >> "$LOG"
}
cat() { { printf 'cat\tcat'; for a in "$@"; do printf '\t%s' "$a"; done; printf '\n'; } >> "$LOG"; }
export -f python cat
"""


def script_commands(tmp: str, name: str, **env: str) -> list[list[str]]:
    """The commands ``tools/<name>.sh`` runs, in order, from an empty root
    ``tmp``: each ``python`` and ``cat`` of the script is a bash function
    that records its argv (``[env, script, args...]`` and ``["cat",
    files...]``).  The script runs as a copy whose ``/tmp/`` is ``tmp/``
    under the root (the drivers' recorded departure)."""
    os.makedirs(os.path.join(tmp, "tools"), exist_ok=True)
    os.makedirs(os.path.join(tmp, "tmp"), exist_ok=True)
    with open(os.path.join(REPO, "tools", name + ".sh")) as f:
        text = f.read().replace("/tmp/", "tmp/")
    script = os.path.join(tmp, "tools", name + ".sh")
    with open(script, "w") as f:
        f.write(text)
    log = os.path.join(tmp, "commands.log")
    open(log, "w").close()
    clean = {k: v for k, v in os.environ.items() if k not in (
        "NQ", "NQ10", "NQ60", "COVER_SUB", "COVER_JITTER", "R5_ROOT", "R5M_ROOT",
        "BENCH_SCREEN_DTYPE")}
    subprocess.run(["bash", "-c", _RECORDER + "bash tools/%s.sh" % name], cwd=tmp, check=True,
                   env=dict(clean, LOG=log, **env), capture_output=True, timeout=60)
    with open(log) as f:
        return [line.rstrip("\n").split("\t")[1:] for line in f]


def driver_words(cmd, env=None) -> list[str]:
    """A driver's step in the words ``script_commands`` records: ``[env,
    script, args...]`` without the port's ``--device``."""
    cmd = [str(c) for c in cmd]
    assert cmd[0] == sys.executable
    if cmd[1] == "-m":
        rest = cmd[3:]
        if rest[-2:-1] == ["--device"]:
            rest = rest[:-2]
        words = [SCRIPT_OF[cmd[2][len("pfann_tpu_torch."):]], *rest]
    else:
        assert cmd[1].startswith(REPO + os.sep), cmd
        words = [os.path.relpath(cmd[1], REPO), *cmd[2:]]
    return ["".join("%s=%s" % kv for kv in (env or {}).items()), *words]


def record_steps(monkeypatch, *modules) -> list[list[str]]:
    """Patch the step runners the driver modules hold (``check``,
    ``check_all``, ``concat``, ``tee_last_line``) to record each step, in
    ``script_commands``' words, and run nothing; returns the list."""
    steps = []

    def check(cmd, cwd=None, echo=False, code=None, env=None):
        steps.append(driver_words(cmd, env))

    def check_all(cmds, jobs=1, cwd=None, code=None, echo=False):
        for cmd in cmds:
            check(cmd)

    def concat(paths, out):
        steps.append(["cat", *paths])

    def tee_last_line(cmd, out, env=None):
        check(cmd, env=env)

    for module in modules:
        for name, fn in (("check", check), ("check_all", check_all), ("concat", concat),
                         ("tee_last_line", tee_last_line)):
            if hasattr(module, name):
                monkeypatch.setattr(module, name, fn)
    return steps
