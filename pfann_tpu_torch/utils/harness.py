"""Steps of the evaluation-harness drivers (``genall``, ``testall`` and
``tools/{run_synth_pipeline,r04_pipeline,r04_rescue,r04_scale30k,
r04_scale30k_resume,r04_bench,r05_calibrate,r05_flagship}``).

Each step is a child process, as in the shell scripts the drivers port:
the port's CLIs run as ``python -m pfann_tpu_torch.<cli>``, and the
host-only tools that both packages share (``tools/accuracy.py``,
``tools/make_variant_db.py``, ``ensemble/fuse_synth.py``, ...) run by path
from the repository, whatever the working directory.  A child finds the
package through ``PYTHONPATH``, so the drivers also run from a scratch
working directory.  ``--jobs N`` (default 1, the scripts' order) runs a
driver's per-SNR steps N at a time: each is a process that spends seconds
starting (torch, the card) for little work at small sizes.
"""

from __future__ import annotations

import concurrent.futures
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SNRS = (-6, -4, -2, 0, 2, 4, 6, 8)


def repo_path(*parts: str) -> str:
    return os.path.join(REPO, *parts)


def port(cli: str, *args) -> list[str]:
    """argv of ``python -m pfann_tpu_torch.<cli> args...``."""
    return [sys.executable, "-m", "pfann_tpu_torch." + cli, *map(str, args)]


def host_tool(rel: str, *args) -> list[str]:
    """argv of a shared host tool of the repository, by path."""
    return [sys.executable, repo_path(rel), *map(str, args)]


def child_env() -> dict[str, str]:
    env = dict(os.environ)
    path = env.get("PYTHONPATH")
    env["PYTHONPATH"] = REPO + (os.pathsep + path if path else "")
    return env


def call(cmd: list[str], cwd: str | None = None, echo: bool = False) -> int:
    """Run one step with this process's stdout and stderr; its exit code.
    ``echo`` prints the command first, as ``set -x`` does."""
    if echo:
        print("+ " + " ".join(cmd), file=sys.stderr, flush=True)
    sys.stdout.flush()
    return subprocess.call(cmd, cwd=cwd, env=child_env())


def check(cmd: list[str], cwd: str | None = None, echo: bool = False,
          code: int | None = None) -> None:
    """Run one step; a failure stops the driver with ``code`` (default:
    the step's own exit code, as ``set -e`` does)."""
    rc = call(cmd, cwd=cwd, echo=echo)
    if rc:
        raise SystemExit(rc if code is None else code)


def check_all(cmds: list[list[str]], jobs: int = 1, cwd: str | None = None,
              code: int | None = None, echo: bool = False) -> None:
    """Run independent steps (one per SNR set, say) in list order, at most
    ``jobs`` at once; ``jobs=1`` is the scripts' one-after-another.  The
    first failing step in list order stops the driver as ``check`` does,
    once the steps beside it have ended; steps not yet started never
    start."""
    if jobs <= 1:
        for cmd in cmds:
            check(cmd, cwd=cwd, code=code, echo=echo)
        return
    sys.stdout.flush()
    with concurrent.futures.ThreadPoolExecutor(jobs) as pool:
        runs = [pool.submit(call, cmd, cwd, echo) for cmd in cmds]
        for run in runs:
            rc = run.result()
            if rc:
                pool.shutdown(cancel_futures=True)
                raise SystemExit(rc if code is None else code)


def pop_jobs_flag(argv: list[str]) -> int:
    """Remove ``--jobs N`` from argv (in place); returns N (default 1)."""
    if "--jobs" not in argv:
        return 1
    at = argv.index("--jobs")
    if at + 1 >= len(argv) or not argv[at + 1].isdigit() or int(argv[at + 1]) < 1:
        raise SystemExit("--jobs needs a positive count")
    jobs = int(argv[at + 1])
    del argv[at : at + 2]
    return jobs


def timed(name: str, cmd: list[str], cwd: str | None = None) -> None:
    """``check`` with ``set -x``'s echo, then a ``step <name> <wall> s``
    line."""
    t0 = time.perf_counter()
    check(cmd, cwd=cwd, echo=True)
    print("step %s %.3f s" % (name, time.perf_counter() - t0), flush=True)


def tee_last_line(cmd: list[str], out: str, env: dict[str, str] | None = None) -> None:
    """``cmd | tail -1 | tee <out>``, except that a failing step stops the
    driver with its exit code (the pipe hides it) and writes nothing."""
    sys.stdout.flush()
    proc = subprocess.run(cmd, env=child_env() | (env or {}), stdout=subprocess.PIPE,
                          text=True)
    if proc.returncode:
        sys.stdout.write(proc.stdout)
        raise SystemExit(proc.returncode)
    lines = proc.stdout.splitlines()
    last = lines[-1] + "\n" if lines else ""
    sys.stdout.write(last)
    with open(out, "w") as f:
        f.write(last)


def concat(paths: list[str], out: str) -> None:
    """``cat paths... > out``, echoed as ``set -x`` does."""
    print("+ cat %s > %s" % (" ".join(paths), out), file=sys.stderr, flush=True)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "wb") as f:
        for path in paths:
            with open(path, "rb") as src:
                f.write(src.read())


def env_or(name: str, default: str) -> str:
    """``${NAME:-default}``: the variable, or ``default`` where it is
    unset or empty."""
    return os.environ.get(name) or default


def stamp(message: str) -> None:
    """The r04 scripts' ``step``: ``=== [HH:MM:SS] message``."""
    print("=== [%s] %s" % (time.strftime("%H:%M:%S"), message), flush=True)
