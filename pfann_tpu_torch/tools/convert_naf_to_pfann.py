"""Convert a TensorFlow neural-audio-fp checkpoint to the DB model format,
on the port: no flax, no msgpack package.

    python -m pfann_tpu_torch.tools.convert_naf_to_pfann <checkpoint_name> \
        [--checkpoint-index N] [--config default] <out dir>

Same bytes as the JAX ``tools/convert_naf_to_pfann.py`` (reference
tools/convert_naf_to_pfann.py): run it from inside a checkout of
https://github.com/mimbres/neural-audio-fp with TensorFlow installed (it
imports that repo's ``run`` and ``model.generate``).  Emits model.msgpack
and a configs.json with the NAF front-end flags (naf_mode, mel_log=log10,
spec_norm=max, ELU, relu_after_bn=false, per-layer strides).

TF conv kernels are HWIO and TF LayerNorms store (F, T, C) affine params;
both go through the reference's torch layout (OIHW / (C, F, T)), so the
mapping is ``convert_pfann_torch.convert_state_dict``'s.
"""

import argparse
import json
import os

import numpy as np

from pfann_tpu_torch.tools.convert_pfann_torch import convert_state_dict
from pfann_tpu_torch.utils.checkpoint import save_model


def tf_to_torch_layout(m_fp) -> tuple[dict, list, int, int]:
    """neural-audio-fp keras model -> torch-layout numpy state dict."""
    out = {}
    strides = []
    for lv, conv in enumerate(m_fp.front_conv.layers[:-1]):
        p = "f.convs.%d" % lv
        # TF HWIO -> torch OIHW
        out[p + ".conv1.weight"] = conv.conv2d_1x3.get_weights()[0].transpose(3, 2, 0, 1)
        out[p + ".conv1.bias"] = conv.conv2d_1x3.get_weights()[1]
        out[p + ".ln1.weight"] = conv.BN_1x3.get_weights()[0].transpose(2, 0, 1)
        out[p + ".ln1.bias"] = conv.BN_1x3.get_weights()[1].transpose(2, 0, 1)
        out[p + ".conv2.weight"] = conv.conv2d_3x1.get_weights()[0].transpose(3, 2, 0, 1)
        out[p + ".conv2.bias"] = conv.conv2d_3x1.get_weights()[1]
        out[p + ".ln2.weight"] = conv.BN_3x1.get_weights()[0].transpose(2, 0, 1)
        out[p + ".ln2.bias"] = conv.BN_3x1.get_weights()[1].transpose(2, 0, 1)
        strides.append((conv.conv2d_1x3.strides, conv.conv2d_3x1.strides))

    fc1w, fc1b, fc2w, fc2b = [], [], [], []
    for seq in m_fp.div_enc.split_fc_layers:
        fc1w.append(np.asarray(seq.layers[0].weights[0]))
        fc1b.append(np.asarray(seq.layers[0].weights[1]))
        fc2w.append(np.asarray(seq.layers[1].weights[0]))
        fc2b.append(np.asarray(seq.layers[1].weights[1]))
    u = fc1b[0].shape[0]
    h = out["f.convs.%d.conv2.bias" % (len(strides) - 1)].shape[0]
    out["g.linear1.weight"] = np.expand_dims(np.concatenate(fc1w, axis=1).T, 2)
    out["g.linear1.bias"] = np.concatenate(fc1b)
    out["g.linear2.weight"] = np.expand_dims(np.concatenate(fc2w, axis=1).T, 2)
    out["g.linear2.bias"] = np.concatenate(fc2b)
    return out, strides, h, u


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkpoint_name")
    ap.add_argument("--checkpoint-index")
    ap.add_argument("--config", default="default")
    ap.add_argument("pfann")
    args = ap.parse_args(None if argv is None else argv[1:])

    try:
        import run  # neural-audio-fp repo modules
        from model.generate import build_fp, load_checkpoint
    except ImportError:
        raise SystemExit(
            "run this tool from inside a neural-audio-fp checkout with "
            "TensorFlow installed; alternatively convert via the reference "
            "repo and pfann_tpu_torch.tools.convert_pfann_torch"
        )

    cfg = run.load_config(args.config)
    m_pre, m_fp = build_fp(cfg)
    load_checkpoint(
        cfg["DIR"]["LOG_ROOT_DIR"] + "checkpoint/",
        args.checkpoint_name, args.checkpoint_index, m_fp,
    )
    n_frame = int(cfg["MODEL"]["DUR"] * cfg["MODEL"]["FS"])
    m_fp(m_pre(np.zeros([1, 1, n_frame])))  # build weights

    state, strides, h, u = tf_to_torch_layout(m_fp)
    d = cfg["MODEL"]["EMB_SZ"]
    os.makedirs(args.pfann, exist_ok=True)
    save_model(os.path.join(args.pfann, "model.msgpack"), convert_state_dict(state, d, h, u))

    params = {
        "model_dir": args.pfann,
        "fftconv_n": 32768,
        "sample_rate": cfg["MODEL"]["FS"],
        "stft_n": cfg["MODEL"]["STFT_WIN"],
        "stft_hop": cfg["MODEL"]["STFT_HOP"],
        "n_mels": cfg["MODEL"]["N_MELS"],
        "dynamic_range": 80,
        "f_min": cfg["MODEL"]["F_MIN"],
        "f_max": cfg["MODEL"]["F_MAX"],
        "segment_size": cfg["MODEL"]["DUR"],
        "hop_size": cfg["MODEL"]["HOP"],
        "naf_mode": True,
        "mel_log": "log10",
        "spec_norm": "max",
        "model": {
            "d": d, "h": h, "u": u,
            "fuller": True,
            "conv_activation": "ELU",
            "relu_after_bn": False,
            "strides": strides,
        },
        "indexer": {"top_k": 100},
    }
    with open(os.path.join(args.pfann, "configs.json"), "w") as fout:
        json.dump(params, fout, indent=2)
    print("wrote", args.pfann)


if __name__ == "__main__":
    main()
