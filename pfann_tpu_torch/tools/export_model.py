"""Export serving weights (``model.msgpack``) from a training checkpoint,
on the port (``tools/export_model.py``'s counterpart).

    python -m pfann_tpu_torch.tools.export_model <model dir> [epoch]

Reads the ``params`` of ``checkpoint{epoch}.ckpt`` (default: the last
finished epoch per ``epochs.txt``), from either package's trainer, checks
them against the model the dir's ``configs.json`` describes, and writes
``<model dir>/model.msgpack``, the builder/matcher serving contract.
"""

import os
import sys

from pfann_tpu_torch.models.fp_network import build_fp_network
from pfann_tpu_torch.utils import checkpoint as ckpt
from pfann_tpu_torch.utils.config import read_config


def main(argv: list[str] | None = None) -> None:
    argv = list(sys.argv if argv is None else argv)
    if len(argv) < 2:
        sys.exit(__doc__)
    model_dir = argv[1]
    params_cfg = read_config(os.path.join(model_dir, "configs.json"))
    epoch = int(argv[2]) if len(argv) > 2 else ckpt.last_epoch(model_dir)
    if epoch < 0:
        sys.exit("no finished epoch recorded in %s/epochs.txt" % model_dir)

    # only the params subtree: the optimizer state is not needed to serve
    # and its layout differs between the packages
    with open(os.path.join(model_dir, "checkpoint%d.ckpt" % epoch), "rb") as f:
        raw = ckpt.msgpack_restore(f.read())
    state_dict = ckpt.params_from_flax(raw["params"])
    build_fp_network(params_cfg).load_state_dict(state_dict)  # shapes must match
    path = ckpt.save_model(os.path.join(model_dir, ckpt.MODEL_FILE_NAME), state_dict)
    print("exported epoch %d -> %s" % (epoch, path))


if __name__ == "__main__":
    main()
