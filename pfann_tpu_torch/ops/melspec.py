"""Log-mel spectrogram front-end (port of ``pfann_tpu/ops/melspec.py``).

The STFT is the window-folded real DFT of the JAX package: frames @ (win *
cos) and frames @ (win * -sin) as two float32 matmuls, then the mel
filterbank as a third.  Only that ``impl="dft"`` path is ported (the JAX
``impl="fft"`` path is a cross-check).  The module always computes in
float32, whatever dtype the model after it runs in (the JAX package does
the same: ``melspec.py:180``, ``fp_network.py:224``).

Pipeline: volume-normalize (L2 or inf-norm) -> STFT power (magnitude in
``naf_mode``) -> mel -> +1e-8 (naf: +0.06) -> log or log10 -> optional
max-norm.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _hz_to_mel(f, scale: str):
    f = np.asarray(f, dtype=np.float64)
    if scale == "htk":
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(f / min_log_hz) / logstep, mels)


def _mel_to_hz(m, scale: str):
    m = np.asarray(m, dtype=np.float64)
    if scale == "htk":
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(
    n_freqs: int,
    f_min: float,
    f_max: float,
    n_mels: int,
    sample_rate: int,
    mel_scale: str = "htk",
    norm: str | None = None,
) -> np.ndarray:
    """Triangular mel filterbank, [n_freqs, n_mels] float32
    (torchaudio ``melscale_fbanks`` semantics; a numpy copy of the JAX
    package's)."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_min = _hz_to_mel(f_min, mel_scale)
    m_max = _hz_to_mel(f_max, mel_scale)
    m_pts = np.linspace(m_min, m_max, n_mels + 2)
    f_pts = _mel_to_hz(m_pts, mel_scale)

    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))

    if norm == "slaney":
        enorm = 2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels])
        fb *= enorm[None, :]
    return fb.astype(np.float32)


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window default periodic=True)."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


class MelSpec(nn.Module):
    """forward(x: [..., n_samples]) -> [..., n_mels, T] float32, with
    T = 1 + n_samples // stft_hop (center=True framing)."""

    def __init__(
        self,
        sample_rate: int = 8000,
        stft_n: int = 1024,
        stft_hop: int = 256,
        f_min: float = 300,
        f_max: float = 4000,
        n_mels: int = 256,
        naf_mode: bool = False,
        mel_log: str = "log",
        spec_norm: str = "l2",
    ):
        super().__init__()
        self.stft_n = stft_n
        self.stft_hop = stft_hop
        self.naf_mode = naf_mode
        self.mel_log = mel_log
        self.spec_norm = spec_norm
        self.pad_mode = "constant" if naf_mode else "reflect"
        self.power = 1 if naf_mode else 2

        n_freqs = stft_n // 2 + 1
        fb = mel_filterbank(
            n_freqs, f_min, f_max, n_mels, sample_rate,
            mel_scale="slaney" if naf_mode else "htk",
            norm="slaney" if naf_mode else None,
        )
        win = hann_window(stft_n)
        n = np.arange(stft_n)[:, None]
        k = np.arange(n_freqs)[None, :]
        ang = 2.0 * np.pi * n * k / stft_n
        self.register_buffer("fbank", torch.from_numpy(fb))
        self.register_buffer(
            "wcos", torch.from_numpy(win[:, None] * np.cos(ang).astype(np.float32))
        )
        self.register_buffer(
            "wsin", torch.from_numpy(win[:, None] * -np.sin(ang).astype(np.float32))
        )

    def frames(self, x: torch.Tensor) -> torch.Tensor:
        """Center-padded overlapping frames: [..., T, stft_n]."""
        pad = self.stft_n // 2
        lead = x.shape[:-1]
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode=self.pad_mode)
        return x.reshape(*lead, -1).unfold(-1, self.stft_n, self.stft_hop)

    def spectrogram(self, x: torch.Tensor) -> torch.Tensor:
        """Power (or magnitude) spectrogram, [..., T, n_freqs] float32."""
        frames = self.frames(x)
        re = torch.matmul(frames, self.wcos)
        im = torch.matmul(frames, self.wsin)
        power = re * re + im * im
        if self.power == 1:
            power = torch.sqrt(torch.clamp(power, min=0.0))
        return power

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.spec_norm == "max":
            denom = x.abs().amax(dim=-1, keepdim=True)
        else:
            denom = torch.sqrt((x * x).sum(dim=-1, keepdim=True))
        x = x / torch.clamp(denom, min=1e-12)

        mel = torch.matmul(self.spectrogram(x), self.fbank).transpose(-1, -2)
        mel = mel + (0.06 if self.naf_mode else 1e-8)
        if self.mel_log == "log10":
            mel = torch.log10(mel)
        elif self.mel_log == "log":
            mel = torch.log(mel)
        if self.spec_norm == "max":
            mel = mel - mel.amax(dim=(-2, -1), keepdim=True)
        return mel


def build_mel_spec_layer(params: dict[str, Any]) -> MelSpec:
    """Build from a pfann-style config dict."""
    return MelSpec(
        sample_rate=params["sample_rate"],
        stft_n=params["stft_n"],
        stft_hop=params["stft_hop"],
        f_min=params["f_min"],
        f_max=params["f_max"],
        n_mels=params["n_mels"],
        naf_mode=params.get("naf_mode", False),
        mel_log=params.get("mel_log", "log"),
        spec_norm=params.get("spec_norm", "l2"),
    )
