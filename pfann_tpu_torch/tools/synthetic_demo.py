"""Self-contained demo on the port: synthesize a music corpus, train a tiny
fingerprinter, build a database, generate noisy queries, match them and
print accuracy, with no dataset (``examples/synthetic_demo.py``'s
counterpart).

    python -m pfann_tpu_torch.tools.synthetic_demo [workdir] [--device cuda|cpu]

Training is a short loop over the port's log-mel, FpNetwork and NT-Xent
loss with Adam; the database build and the matching run through
``python -m pfann_tpu_torch.builder`` and ``python -m
pfann_tpu_torch.matcher`` in subprocesses, on the same device.
"""

import csv
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from pfann_tpu_torch.audio.io import write_wav
from pfann_tpu_torch.data.musicdata import unfold
from pfann_tpu_torch.models.fp_network import build_fp_network, init_like_flax
from pfann_tpu_torch.ops.melspec import build_mel_spec_layer
from pfann_tpu_torch.train.loss import similarity_loss
from pfann_tpu_torch.utils.checkpoint import save_model
from pfann_tpu_torch.utils.config import write_config
from pfann_tpu_torch.utils.device import pop_device_flag, resolve_device


def make_song(rng, n_sec, sr=8000):
    """Non-stationary synthetic 'music': a random chord sequence."""
    note = sr // 4
    x = np.zeros(n_sec * sr)
    t = np.arange(note) / sr
    env = np.minimum(np.minimum(np.arange(note), np.arange(note)[::-1]) / (note / 8), 1)
    for k in range(n_sec * 4):
        for _ in range(3):
            f = rng.uniform(150, 3400)
            x[k * note : (k + 1) * note] += (
                rng.uniform(0.3, 1.0) * env
                * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
            )
    return (x / (np.abs(x).max() * 1.2)).astype(np.float32)


def main(argv: list[str] | None = None) -> None:
    argv = list(sys.argv if argv is None else argv)
    device_name = pop_device_flag(argv)
    device = resolve_device(device_name)
    root = argv[1] if len(argv) > 1 else tempfile.mkdtemp(prefix="pfann_demo")
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    print("== workdir:", root)

    # 1. corpus ----------------------------------------------------------
    music_dir = os.path.join(root, "music")
    os.makedirs(music_dir, exist_ok=True)
    songs = []
    for i in range(8):
        wav = make_song(rng, 10)
        path = os.path.join(music_dir, "song%02d.wav" % i)
        write_wav(path, wav, 8000)
        songs.append((path, wav))
    print("== synthesized %d songs" % len(songs))

    # 2. tiny model, briefly trained on the corpus ------------------------
    model_dir = os.path.join(root, "model")
    os.makedirs(model_dir, exist_ok=True)
    cfg = {
        "model_dir": model_dir, "cache_dir": os.path.join(root, "caches"),
        "batch_size": 32, "sample_rate": 8000, "stft_n": 1024,
        "stft_hop": 256, "n_mels": 256, "f_min": 300, "f_max": 4000,
        "segment_size": 1, "hop_size": 0.5, "time_offset": 1.2,
        "pad_start": 0, "epoch": 1, "lr": 1e-3, "tau": 0.05,
        "cutout_min": 0.1, "cutout_max": 0.5,
        "model": {"d": 32, "h": 128, "u": 8, "fuller": True},
        "indexer": {"top_k": 10, "frame_shift_mul": 1},
    }
    cfg_path = os.path.join(model_dir, "configs.json")
    write_config(cfg, cfg_path)

    torch.manual_seed(0)  # CPU fallbacks of any op that draws
    model = build_fp_network(cfg).to(device)
    init_like_flax(model, torch.Generator().manual_seed(0))
    mel = build_mel_spec_layer(cfg).to(device)
    segs = np.concatenate([unfold(w, 8000, 4000) for _, w in songs])
    segs = segs - segs.mean(axis=1, keepdims=True)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)  # 3e-3 collapses this tiny config

    for it in range(120):
        idx = rng.choice(segs.shape[0], 16, replace=False)
        org = segs[idx]
        aug = org + 0.15 * rng.standard_normal(org.shape).astype(np.float32)
        batch = torch.from_numpy(np.stack([org, aug], 1).reshape(-1, 8000)).to(device)
        opt.zero_grad(set_to_none=True)
        loss = similarity_loss(model(mel(batch)), 0.05)
        loss.backward()
        opt.step()
        if it % 40 == 0:
            print("  train it %3d  loss %.3f" % (it, float(loss)))
    save_model(os.path.join(model_dir, "model.msgpack"), model.state_dict())
    print("== trained tiny model (loss %.3f)" % float(loss))

    # 3. build the database via the builder CLI ---------------------------
    lst = os.path.join(root, "db_list.txt")
    with open(lst, "w") as f:
        f.writelines(p + "\n" for p, _ in songs)
    db_dir = os.path.join(root, "db")
    subprocess.run(
        [sys.executable, "-m", "pfann_tpu_torch.builder", lst, db_dir, cfg_path,
         "--device", device_name],
        check=True,
    )
    print("== database built:", sorted(os.listdir(db_dir)))

    # 4. noisy queries -----------------------------------------------------
    qdir = os.path.join(root, "queries")
    os.makedirs(qdir, exist_ok=True)
    qlist = os.path.join(root, "qlist.txt")
    truths = []
    with open(qlist, "w") as f:
        for qi in range(10):
            sid = int(rng.integers(0, len(songs)))
            path, wav = songs[sid]
            start = int(rng.integers(0, len(wav) - 3 * 8000))
            q = wav[start : start + 3 * 8000].copy()
            q += 0.05 * rng.standard_normal(q.shape).astype(np.float32)
            qp = os.path.join(qdir, "q%02d.wav" % qi)
            write_wav(qp, q, 8000)
            f.write(qp + "\n")
            truths.append((path, start / 8000))

    # 5. match via the matcher CLI ----------------------------------------
    result = os.path.join(root, "result.txt")
    subprocess.run(
        [sys.executable, "-m", "pfann_tpu_torch.matcher", qlist, db_dir, result,
         "--device", device_name],
        check=True,
    )

    # 6. score -------------------------------------------------------------
    correct = near = 0
    with open(os.path.splitext(result)[0] + "_detail.csv") as f:
        reader = csv.DictReader(f)
        for row, (ans, t0) in zip(reader, truths):
            ok = os.path.basename(row["answer"]) == os.path.basename(ans)
            correct += ok
            near += ok and abs(float(row["time"]) - t0) <= 0.5
    print("== song accuracy: %d/10, near (<=0.5 s): %d/10" % (correct, near))


if __name__ == "__main__":
    main()
