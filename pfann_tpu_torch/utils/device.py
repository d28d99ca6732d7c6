"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """``--device`` value -> torch.device.  Asking for CUDA where no card
    is visible raises: the port never carries on on the CPU unasked."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device %r requested but torch.cuda.is_available() is false "
            "(pass --device cpu to run on the CPU)" % name
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %r (cuda or cpu)" % name)
    return device


def pop_device_flag(argv: list[str], default: str = "cuda") -> str:
    """Remove ``--device <name>`` from argv (in place); returns the name."""
    if "--device" not in argv:
        return default
    at = argv.index("--device")
    if at + 1 >= len(argv):
        raise SystemExit("--device needs a value (cuda or cpu)")
    name = argv[at + 1]
    del argv[at : at + 2]
    return name
