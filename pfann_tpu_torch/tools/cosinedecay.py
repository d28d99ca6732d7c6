"""Plot the learning-rate schedule the port's trainer uses
(``tools/cosinedecay.py``'s counterpart, over ``train/schedule.py``).

    python -m pfann_tpu_torch.tools.cosinedecay [--epochs 100] [--lr 1e-4] [-o lr.png]

Without matplotlib it prints one ``epoch lr`` line per epoch and exits
nonzero, as the JAX tool does.
"""

import argparse
import os
import sys

from pfann_tpu_torch.train.schedule import cosine_warm_restarts


def main(argv: list[str] | None = None) -> None:
    argv = list(sys.argv if argv is None else argv)
    ap = argparse.ArgumentParser(prog="python -m pfann_tpu_torch.tools.cosinedecay")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--t0", type=int, default=None,
                    help="restart period (default: epochs, i.e. no restart)")
    ap.add_argument("--eta-min", type=float, default=1e-7)
    ap.add_argument("-o", "--out", default=None,
                    help="output image (default: show, or lr.png headless)")
    args = ap.parse_args(argv[1:])

    sched = cosine_warm_restarts(args.lr, args.t0 or args.epochs, eta_min=args.eta_min)
    lrs = [sched(e) for e in range(args.epochs)]

    try:
        import matplotlib

        if args.out or not os.environ.get("DISPLAY"):
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        for e, lr in enumerate(lrs):
            print(e, lr)
        raise SystemExit("matplotlib not available; printed values instead")

    plt.xlabel("epoch")
    plt.ylabel("learning rate")
    plt.plot(lrs)
    if args.out or not os.environ.get("DISPLAY"):
        out = args.out or "lr.png"
        plt.savefig(out, dpi=150)
        print("saved", out)
    else:
        plt.show()


if __name__ == "__main__":
    main()
