"""The round-4 bench artifacts on the port.

    python -m pfann_tpu_torch.tools.r04_bench [--device cuda|cpu]

The port of ``tools/r04_bench.sh``, step for step, one after another:
``python -m pfann_tpu_torch.bench`` in each of its modes below, its last
line written to the script's file in the working directory (which must
hold ``configs/synth.json`` and the corpus it names, as
``run_synth_pipeline`` leaves them):

  train epoch             ``--train-epoch configs/synth.json``  ``BENCH_r04_train.json``
  build                   ``--build 1000``                      ``BENCH_r04_build.json``
  landmark                ``--lm 64``                           ``BENCH_r04_landmark.json``
  scale 100k f32 coarse   ``--scale 100000``                    ``BENCH_r04_scale.json``
  scale 100k int8 coarse  ``--scale 100000`` with               ``BENCH_r04_scale_int8.json``
                          ``BENCH_SCREEN_DTYPE=int8``

(the script's step names; the bench's default stage-1 dtype is the
layout's, bf16).  Every bench gets ``--device`` (default cuda, which
raises where no card is visible); a failing mode stops the driver with
its exit code (the script's ``| tail -1 | tee`` hides it) and writes no
file.  The script's ``PFANN_COMPILE_CACHE`` export has no counterpart
(see ``r04_pipeline``).
"""

from __future__ import annotations

import sys

from pfann_tpu_torch.utils.device import pop_device_flag, resolve_device
from pfann_tpu_torch.utils.harness import port, stamp, tee_last_line

# (step, bench argv, output file, extra environment)
MODES = (
    ("train epoch", ("--train-epoch", "configs/synth.json"), "BENCH_r04_train.json", None),
    ("build", ("--build", 1000), "BENCH_r04_build.json", None),
    ("landmark", ("--lm", 64), "BENCH_r04_landmark.json", None),
    ("scale 100k f32 coarse", ("--scale", 100000), "BENCH_r04_scale.json", None),
    ("scale 100k int8 coarse", ("--scale", 100000), "BENCH_r04_scale_int8.json",
     {"BENCH_SCREEN_DTYPE": "int8"}),
)


def main(argv: list[str] | None = None) -> None:
    argv = list(sys.argv if argv is None else argv)
    device = pop_device_flag(argv)
    resolve_device(device)
    for step, args, out, env in MODES:
        stamp(step)
        tee_last_line(port("bench", *args, "--device", device), out, env=env)
    stamp("done")


if __name__ == "__main__":
    main()
