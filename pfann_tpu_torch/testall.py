"""Build -> match -> accuracy per model and dataset, on the port.

    python -m pfann_tpu_torch.testall <model> <dataset> [-build] [-match] \
        [-accuracy] [-match_snr] [-accuracy_snr] [-match_snr_full] \
        [-accuracy_snr_full] [--device cuda|cpu] [--jobs N]

The port of ``testall.sh``: the same argv, dataset table, ``out/`` paths,
action order and exit codes, run from the working directory.
model:   any ``out/models/<model>`` dir; ``lm*`` is the landmark system
dataset: inside | out1 | out2 | mirex | synth | synth2s | synth3s |
         synth5s | r5 | r5m
The NN arm runs ``python -m pfann_tpu_torch.{builder,matcher}`` (one
``matcher --pairs --batch 128`` for all SNR sets), the landmark arm
``lm_builder`` and ``lm_matcher`` (or the external ``../pfa/matcher`` where
it is executable); every port CLI gets ``--device`` (default cuda, which
raises where no card is visible).  Accuracy comes from the shared
``tools/accuracy.py`` and ``tools/mirexacc.py``.  A failing step exits 1;
an unknown action or dataset exits 2.  (``testall.sh`` meant 2 for an
unknown dataset too, but its ``exit 2`` runs inside ``$(db_list)``, a
subshell, so the script goes on and exits 1 when the builder fails on
the empty list.)  ``--jobs N`` runs the landmark arm's per-SNR matchers N
at a time.
"""

from __future__ import annotations

import os
import sys

from pfann_tpu_torch.utils.device import pop_device_flag, resolve_device
from pfann_tpu_torch.utils.harness import (
    SNRS,
    check,
    check_all,
    host_tool,
    pop_jobs_flag,
    port,
)

LISTS = {
    "inside": "lists/fma_medium_train.txt",
    "out1": "lists/fma_out1.txt",
    "out2": "lists/fma_out2.txt",
    "mirex": "lists/mirex-db.txt",
    "synth": "out/synth_dataset/lists/db.txt",
    "synth2s": "out/synth_dataset/lists/db.txt",
    "synth3s": "out/synth_dataset/lists/db.txt",
    "synth5s": "out/synth_dataset/lists/db.txt",
    # round-5 flagship eval: both query-length sets share the merged
    # 31.7k-track DB's own song list (tools/r05_flagship.sh)
    "r5": "out/dbs/flagship_r5/songList.txt",
    "r5m": "out/dbs/flagship_r5/songList.txt",
}
# query-length variants share their base dataset's DB (synth2s -> synth)
DB_NAMES = {"synth2s": "synth", "synth3s": "synth", "synth5s": "synth", "r5m": "r5"}
EXTERNAL_LM_MATCHER = "../pfa/matcher"


class Harness:
    def __init__(self, model: str, dataset: str, device: str, jobs: int = 1):
        self.model, self.dataset, self.device, self.jobs = model, dataset, device, jobs
        self.landmark = model.startswith("lm")

    def fail(self, message: str) -> None:
        print(message, file=sys.stderr, flush=True)
        raise SystemExit(2)

    def db_list(self) -> str:
        if self.dataset not in LISTS:
            self.fail("%s is not a supported dataset" % self.dataset)
        return LISTS[self.dataset]

    def db_dir(self, name: str | None = None) -> str:
        name = DB_NAMES.get(self.dataset, self.dataset) if name is None else name
        return "out/dbs/%s_%s" % (self.model, name)

    def port(self, cli: str, *args) -> list[str]:
        return port(cli, *args, "--device", self.device)

    def match_cmd(self, query_list: str, db_dir: str, result: str) -> list[str]:
        """One query list against one DB (the shell's ``match_prog``)."""
        if self.landmark:
            if os.access(EXTERNAL_LM_MATCHER, os.X_OK):
                return [EXTERNAL_LM_MATCHER, query_list, db_dir, result]
            return self.port("lm_matcher", query_list, db_dir, result)
        return self.port("matcher", query_list, db_dir, result)

    def accuracy(self, expected: str, result: str) -> None:
        if self.landmark:
            detail = result + ".csv"
        else:
            detail = (result[: -len(".txt")] if result.endswith(".txt") else result) \
                + "_detail.csv"
        check(host_tool("tools/accuracy.py", expected, detail), code=1)

    def results(self, infix: str = "") -> list[tuple[str, str]]:
        return [("out/queries/%s_snr%d/list.txt" % (self.dataset, snr),
                 "out/results/%s_%s%s_snr%d.txt" % (self.model, self.dataset, infix, snr))
                for snr in SNRS]

    def match_snr(self, db_dir: str, infix: str = "") -> None:
        sets = self.results(infix)
        if self.landmark:
            check_all([self.match_cmd(query_list, db_dir, result) for query_list, result in sets],
                      jobs=self.jobs, code=1)
        else:
            # one matcher process for all SNR sets: model load and kernel
            # build dominate a cold run, --pairs amortizes them 8x
            pairs = [p for pair in sets for p in pair]
            check(self.port("matcher", "--pairs", "--batch", 128, db_dir, *pairs), code=1)

    def accuracy_snr(self, infix: str = "") -> None:
        for snr, (_, result) in zip(SNRS, self.results(infix)):
            print("snr=%d" % snr, flush=True)
            self.accuracy("out/queries/%s_snr%d/expected.csv" % (self.dataset, snr), result)

    def run(self, action: str) -> None:
        single = "out/results/%s_%s.txt" % (self.model, self.dataset)
        if action == "-build":
            if self.landmark:
                check(self.port("lm_builder", self.db_list(), self.db_dir()), code=1)
            else:
                check(self.port("builder", self.db_list(), self.db_dir(),
                                "out/models/" + self.model), code=1)
        elif action == "-match":
            query_list = ("lists/mirex-query.txt" if self.dataset == "mirex"
                          else "out/queries/%s/list.txt" % self.dataset)
            check(self.match_cmd(query_list, self.db_dir(), single), code=1)
        elif action == "-accuracy":
            if self.dataset == "mirex":
                check(host_tool("tools/mirexacc.py", "lists/mirex-answer.txt", single), code=1)
            else:
                self.accuracy("out/queries/%s/expected.csv" % self.dataset, single)
        elif action == "-match_snr":
            self.match_snr(self.db_dir())
        elif action == "-accuracy_snr":
            self.accuracy_snr()
        elif action == "-match_snr_full":
            self.match_snr(self.db_dir("full"), "_full")
        elif action == "-accuracy_snr_full":
            self.accuracy_snr("_full")
        else:
            self.fail("unknown action %s" % action)


def main(argv: list[str] | None = None) -> None:
    argv = list(sys.argv if argv is None else argv)
    device = pop_device_flag(argv)
    jobs = pop_jobs_flag(argv)
    if len(argv) < 3:
        print("usage: python -m pfann_tpu_torch.testall <model> <dataset> [-build] "
              "[-match] [-accuracy] [-match_snr] [-accuracy_snr] [-match_snr_full] "
              "[-accuracy_snr_full] [--device cuda|cpu] [--jobs N]", file=sys.stderr)
        raise SystemExit(1)
    resolve_device(device)
    harness = Harness(argv[1], argv[2], device, jobs)
    os.makedirs("out/dbs", exist_ok=True)
    os.makedirs("out/results", exist_ok=True)
    for action in argv[3:]:
        harness.run(action)


if __name__ == "__main__":
    main()
