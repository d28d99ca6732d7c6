"""Convert a reference pfann ``model.pt`` (torch state dict) to a
``model.msgpack``, on the port: no flax, no msgpack package.

    python -m pfann_tpu_torch.tools.convert_pfann_torch <model.pt> <configs.json> <out.msgpack>

Same bytes as the JAX ``tools/convert_pfann_torch.py``.  The reference's
state dict is the port's FpNetwork layout up to names and the projector
(reference model.py:14-130 -> pfann_tpu_torch/models/fp_network.py):
  f.convs.{i}.conv{1,2}.*, ln{1,2}.*      -> f.block{i}.conv{1,2}.*, ln{1,2}.*
  g.linear1.weight [d*u, v, 1] (groups=d)  -> g.w1 [d, v, u]
  g.linear2.weight [d, u, 1]  (groups=d)   -> g.w2 [d, u, 1]
and ``utils/checkpoint.save_model`` writes it in the flax layout.

A reference model saved while "hacked" (weight-flip SAME-padding trick,
model.py:38-52) must be un-hacked before export; normal training never
saves hacked weights.
"""

import argparse

import numpy as np
import torch

from pfann_tpu_torch.utils.checkpoint import save_model
from pfann_tpu_torch.utils.config import read_config


def convert_state_dict(state: dict, d: int, h: int, u: int) -> dict[str, torch.Tensor]:
    """Reference torch state dict (tensors or numpy) -> the port's
    FpNetwork state dict (f32 CPU tensors)."""

    def arr(key):
        t = state[key]
        return torch.as_tensor(np.asarray(
            t.detach().cpu().numpy() if hasattr(t, "detach") else t, dtype=np.float32))

    sd: dict[str, torch.Tensor] = {}
    i = 0
    while "f.convs.%d.conv1.weight" % i in state:
        for layer in ("conv1", "ln1", "conv2", "ln2"):
            for p in ("weight", "bias"):
                sd["f.block%d.%s.%s" % (i, layer, p)] = arr(
                    "f.convs.%d.%s.%s" % (i, layer, p))
        i += 1
    if i != 8:
        raise ValueError("expected 8 conv blocks, found %d" % i)

    v = h // d
    sd["g.w1"] = arr("g.linear1.weight")[:, :, 0].reshape(d, u, v).permute(0, 2, 1)
    sd["g.b1"] = arr("g.linear1.bias").reshape(d, u)
    sd["g.w2"] = arr("g.linear2.weight").reshape(d, u, 1)
    sd["g.b2"] = arr("g.linear2.bias").reshape(d, 1)
    return sd


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("model_pt")
    ap.add_argument("configs")
    ap.add_argument("out")
    args = ap.parse_args(None if argv is None else argv[1:])

    m = read_config(args.configs)["model"]
    state = torch.load(args.model_pt, map_location="cpu")
    if "model" in state and not any(k.startswith("f.") for k in state):
        state = state["model"]  # full checkpoint instead of state dict
    save_model(args.out, convert_state_dict(state, m["d"], m["h"], m["u"]))
    print("wrote", args.out)


if __name__ == "__main__":
    main()
