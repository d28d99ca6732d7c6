"""fpbench/flops.py: the counts the per-layer metrics divide by."""

import json
import os

import pytest

from fpbench import flops

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def config(name):
    with open(os.path.join(ROOT, "fpbench", "configs", name + ".json")) as f:
        return json.load(f)


def port_count(cfg):
    """The same operations walked over the program's modules."""
    from pfann_tpu_torch.models.fp_network import build_fp_network

    model = build_fp_network(cfg)
    total = 0
    for block in model.f.blocks:
        for conv, ln in ((block.conv1, block.ln1), (block.conv2, block.ln2)):
            c_out, f_out, t_out = ln.shape
            kh, kw = conv.kernel_size
            total += 2 * c_out * f_out * t_out * (conv.in_channels // conv.groups) * kh * kw
    d, v, u = model.g.w1.shape
    return total + 2 * d * (v * u + u)


@pytest.mark.parametrize("name,gflop", [("nafp-d128-cat10k", 0.582), ("pfann-d64-cat100k", 0.072)])
def test_fpnet_flops(name, gflop):
    cfg = config(name)
    assert flops.fpnet_flops(cfg) / 1e9 == pytest.approx(gflop, abs=5e-4)
    assert flops.fpnet_flops(cfg) == port_count(cfg)


def test_mel_flops_by_hand():
    cfg = config("nafp-d128-cat10k")
    # 32 frames of 1,024 samples against 513 bins, cos and sin, then 256 mels
    assert flops.mel_flops(cfg) == 2 * 2 * 32 * 1024 * 513 + 2 * 32 * 513 * 256
    assert flops.segment_flops(cfg) == flops.mel_flops(cfg) + flops.fpnet_flops(cfg)


def test_align_counts_by_hand():
    # 3 queries of 2 rows of d=4 against 2 songs holding 5 rows in all
    assert flops.align_ops(S=2, d=4, B=3, rows=5) == 3 * 2 * 5 * 4 * 2
    assert flops.align_bytes(S=2, d=4, B=3, rows=5, n_songs=2) == 5 * 4 * 2 + 3 * 2 * 4 * 2 + 3 * 2 * 8
    assert flops.align_bound_s(2, 4, 3, 5, 2) == max(240 / 989e12, 136 / 3.35e12)


def test_align_bound_at_the_cell():
    # d128-10k-audio: 256 queries of 19 rows over 10,000 x 120 rows, bound by operations
    ops = flops.align_ops(19, 128, 256, 1_200_000)
    assert flops.align_bound_s(19, 128, 256, 1_200_000, 10_000) == ops / flops.PEAK_BF16_OPS
    assert ops / flops.PEAK_BF16_OPS == pytest.approx(1.511e-3, rel=1e-3)
