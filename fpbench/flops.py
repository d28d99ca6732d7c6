"""Operations and bytes of the served work, counted from the configuration's
widths and the inputs' sizes (never from the program's modules), and the
peaks they are divided by.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense: 989e12 bf16
operations a second on the tensor cores, 3.35e12 bytes a second of HBM3.
"""

from __future__ import annotations

from fpbench.reference.fpnet import block_shapes, frames_per_segment

PEAK_BF16_OPS = 989e12
HBM_BYTES_S = 3.35e12
BF16_BYTES = 2


def fpnet_flops(cfg: dict) -> int:
    """Operations of one segment through FpNetwork: 2 x the multiply-adds
    of every conv (output volume x inputs per output) and of the
    projector's two grouped products."""
    m = cfg["model"]
    total = 0
    for b in block_shapes(cfg):
        c = b["cout"]
        total += 2 * c * b["F"] * b["T1"] * b["cin"] * 3
        total += 2 * c * b["F2"] * b["T1"] * (c if m.get("fuller", False) else 1) * 3
    d, h, u = m["d"], m["h"], m["u"]
    return total + 2 * d * ((h // d) * u + u)


def mel_flops(cfg: dict) -> int:
    """Operations of one segment's log-mel as the configuration's front end
    defines it: the windowed real DFT as two matrix products (cos, sin)
    over every frame, and the mel filterbank product."""
    frames = frames_per_segment(cfg)
    n_freqs = cfg["stft_n"] // 2 + 1
    return 2 * 2 * frames * cfg["stft_n"] * n_freqs + 2 * frames * n_freqs * cfg["n_mels"]


def segment_flops(cfg: dict) -> int:
    return mel_flops(cfg) + fpnet_flops(cfg)


def align_ops(S: int, d: int, B: int, rows: int) -> int:
    """Operations the exhaustive scan needs: every query row against every
    catalogue row, B queries of S rows over ``rows`` catalogue rows."""
    return 2 * S * d * B * rows


def align_bytes(S: int, d: int, B: int, rows: int, n_songs: int) -> int:
    """Bytes it needs to move once: the bf16 catalogue and queries in, the
    per-song best (f32) and offset (int32) out."""
    return rows * d * BF16_BYTES + B * S * d * BF16_BYTES + B * n_songs * 8


def align_bound_s(S: int, d: int, B: int, rows: int, n_songs: int) -> float:
    """The least time the card could take for one exhaustive scan."""
    return max(align_ops(S, d, B, rows) / PEAK_BF16_OPS,
               align_bytes(S, d, B, rows, n_songs) / HBM_BYTES_S)
