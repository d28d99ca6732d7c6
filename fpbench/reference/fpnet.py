"""Plain reference of the NAFP encoder: waveform -> log-mel -> FpNetwork ->
L2-normalised embedding, in float32 with TF32 off.

Written from the published description (Chang et al., "Neural Audio
Fingerprint for High-specific Audio Retrieval based on Contrastive
Learning", arXiv 2010.11910; stdio2016/pfann's configs): a Hann-windowed
STFT power spectrum, an HTK mel filterbank without norm, log(mel + 1e-8);
eight separable conv blocks (a 1x3 conv striding time, a 3x1 conv striding
frequency, depthwise unless ``fuller``), each conv followed by a LayerNorm
over the whole (C, F, T) volume and ReLU; then the split-FC projector
(h -> d groups of v -> u -> 1 with ELU between) and an L2 norm.  It imports
nothing of the program: it reads the parameters the benchmark drew, keyed
by the names of the checkpoint format the program loads.

``low=True`` is the control: every operand of a conv, LayerNorm output
and projector product is rounded to fp8 (e4m3) with one scale per tensor,
sums in f32 -- the precision below the configuration's bfloat16.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-5
FP8_MAX = 448.0  # largest finite float8_e4m3fn


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls and convs in float32 inside (TF32 would round their
    operands to 10 mantissa bits); the flags as they were after."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8_e4m3fn under one per-tensor scale (amax -> 448),
    returned in float32."""
    amax = float(x.abs().max()) if x.numel() else 0.0
    if amax == 0.0:
        return x.float()
    s = FP8_MAX / amax
    return (x.float() * s).to(torch.float8_e4m3fn).float() / s


def channels(model: dict) -> list[int]:
    d, h = model["d"], model["h"]
    return [1, d, d, 2 * d, 2 * d, 4 * d, 4 * d, h, h]


def frames_per_segment(cfg: dict) -> int:
    """STFT frames of one segment (center=True framing)."""
    return 1 + segment_samples(cfg) // cfg["stft_hop"]


def segment_samples(cfg: dict) -> int:
    return int(cfg["segment_size"] * cfg["sample_rate"])


def block_shapes(cfg: dict) -> list[dict]:
    """Per block: channels in/out and the (F, T) after each of its convs."""
    fdim, tdim = cfg["n_mels"], frames_per_segment(cfg)
    ch = channels(cfg["model"])
    out = []
    for i in range(8):
        t_out = (tdim - 1) // 2 + 1
        f_out = (fdim - 1) // 2 + 1
        out.append(dict(cin=ch[i], cout=ch[i + 1], F=fdim, T=tdim, T1=t_out, F2=f_out))
        fdim, tdim = f_out, t_out
    if not fdim == tdim == 1:
        raise ValueError("eight stride-2 blocks must reduce (F, T) to 1x1")
    return out


def param_shapes(cfg: dict) -> dict[str, tuple]:
    """Every parameter of the encoder and projector, by its checkpoint name."""
    m = cfg["model"]
    shapes = {}
    for i, b in enumerate(block_shapes(cfg)):
        c = b["cout"]
        p = "f.block%d." % i
        shapes[p + "conv1.weight"] = (c, b["cin"], 1, 3)
        shapes[p + "conv1.bias"] = (c,)
        shapes[p + "ln1.weight"] = (c, b["F"], b["T1"])
        shapes[p + "ln1.bias"] = (c, b["F"], b["T1"])
        shapes[p + "conv2.weight"] = (c, c if m.get("fuller", False) else 1, 3, 1)
        shapes[p + "conv2.bias"] = (c,)
        shapes[p + "ln2.weight"] = (c, b["F2"], b["T1"])
        shapes[p + "ln2.bias"] = (c, b["F2"], b["T1"])
    d, h, u = m["d"], m["h"], m["u"]
    shapes["g.w1"] = (d, h // d, u)
    shapes["g.b1"] = (d, u)
    shapes["g.w2"] = (d, u, 1)
    shapes["g.b2"] = (d, 1)
    return shapes


def fan_in(name: str, shape: tuple) -> int | None:
    """Inputs that feed one output of a weight (None for biases and the
    LayerNorm affine)."""
    if name.endswith("conv1.weight") or name.endswith("conv2.weight"):
        return shape[1] * shape[2] * shape[3]
    if name in ("g.w1", "g.w2"):
        return shape[1]
    return None


def mel_filterbank(cfg: dict) -> torch.Tensor:
    """HTK mel triangles over the rfft bins, [n_freqs, n_mels] float32."""
    n_freqs = cfg["stft_n"] // 2 + 1
    sr = cfg["sample_rate"]

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    freqs = np.linspace(0, sr // 2, n_freqs)
    pts = mel_to_hz(np.linspace(hz_to_mel(cfg["f_min"]), hz_to_mel(cfg["f_max"]),
                                cfg["n_mels"] + 2))
    lo, mid, hi = pts[:-2], pts[1:-1], pts[2:]
    rise = (freqs[:, None] - lo[None, :]) / (mid - lo)[None, :]
    fall = (hi[None, :] - freqs[:, None]) / (hi - mid)[None, :]
    return torch.from_numpy(np.maximum(0.0, np.minimum(rise, fall)).astype(np.float32))


def log_mel(x: torch.Tensor, cfg: dict, fbank: torch.Tensor) -> torch.Tensor:
    """Segments [n, samples] -> log-mel [n, n_mels, T]: each segment scaled
    to unit L2 norm, power spectrum of the periodic-Hann STFT (reflect
    padding, centred frames), mel, log(+1e-8)."""
    x = x.float()
    x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp(min=1e-12)
    n = cfg["stft_n"]
    spec = torch.stft(x, n_fft=n, hop_length=cfg["stft_hop"],
                      window=torch.hann_window(n, periodic=True, device=x.device),
                      center=True, pad_mode="reflect", return_complex=True)
    power = spec.real ** 2 + spec.imag ** 2  # [n, n_freqs, T]
    return torch.log(torch.einsum("nft,fm->nmt", power, fbank.to(x.device)) + 1e-8)


def _same(size: int, k: int, s: int) -> tuple[int, int]:
    """TensorFlow's SAME padding (the extra row after)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def encode(mel: torch.Tensor, p: dict, cfg: dict, low: bool = False) -> torch.Tensor:
    """log-mel [n, F, T] -> L2-normalised embeddings [n, d] float32."""
    q = fp8_round if low else (lambda t: t.float())
    m = cfg["model"]
    act = {"ReLU": F.relu, "ELU": F.elu}[m.get("conv_activation", "ReLU")]
    x = mel[:, None].float()
    for i in range(8):
        pre = "f.block%d." % i
        pl, pr = _same(x.shape[3], 3, 2)
        x = F.conv2d(F.pad(q(x), (pl, pr, 0, 0)), q(p[pre + "conv1.weight"]),
                     q(p[pre + "conv1.bias"]), stride=(1, 2))
        x = act(F.layer_norm(x, x.shape[1:], p[pre + "ln1.weight"], p[pre + "ln1.bias"], LN_EPS))
        pl, pr = _same(x.shape[2], 3, 2)
        groups = 1 if m.get("fuller", False) else x.shape[1]
        x = F.conv2d(F.pad(q(x), (0, 0, pl, pr)), q(p[pre + "conv2.weight"]),
                     q(p[pre + "conv2.bias"]), stride=(2, 1), groups=groups)
        x = act(F.layer_norm(x, x.shape[1:], p[pre + "ln2.weight"], p[pre + "ln2.bias"], LN_EPS))
    d = m["d"]
    x = q(x.reshape(x.shape[0], d, -1))
    x = F.elu(torch.einsum("ndv,dvu->ndu", x, q(p["g.w1"])) + q(p["g.b1"]))
    x = torch.einsum("ndu,duo->ndo", q(x), q(p["g.w2"])) + q(p["g.b2"])
    x = x.reshape(-1, d)
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp(min=1e-12)


def segments(signals: torch.Tensor, cfg: dict) -> torch.Tensor:
    """int16 signals [B, L] -> de-meaned segments [B, W, samples] float32 at
    the configuration's hop (W whole windows per signal)."""
    seg = segment_samples(cfg)
    hop = int(round(cfg["hop_size"] * cfg["sample_rate"]))
    x = signals.float() / 32768.0
    w = (x.shape[1] - seg) // hop + 1
    fr = x.unfold(1, seg, hop)[:, :w]
    return fr - fr.mean(dim=2, keepdim=True)


@torch.no_grad()
def embed_signals(signals: torch.Tensor, p: dict, cfg: dict, *, low: bool = False,
                  block: int = 512) -> torch.Tensor:
    """int16 signals [B, L] on a device -> embeddings [B, W, d] float32, in
    blocks of ``block`` segments."""
    fr = segments(signals, cfg)
    B, W, seg = fr.shape
    flat = fr.reshape(B * W, seg)
    fb = mel_filterbank(cfg).to(signals.device)
    out = torch.cat([encode(log_mel(flat[i : i + block], cfg, fb), p, cfg, low)
                     for i in range(0, flat.shape[0], block)])
    return out.reshape(B, W, -1)


def init_std(name: str, shape: tuple) -> float:
    """LeCun-normal scale of a weight; 0 for what starts at a constant."""
    f = fan_in(name, shape)
    return 0.0 if f is None else 1.0 / math.sqrt(f)
