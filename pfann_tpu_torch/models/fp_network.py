"""Fingerprint network (port of ``pfann_tpu/models/fp_network.py``).

Eight separable conv blocks (1xk conv striding T, then kx1 conv striding
F, depthwise unless ``fuller``; each followed by a LayerNorm over the
whole (C, F, T) volume and ReLU/ELU), then the grouped split-FC projector
and an L2 norm.  The public layout is the JAX package's: log-mel
[B, F, T] in, [B, d] float32 out.  Inside, activations are [B, C, F, T].

bf16 is explicit, as flax's ``dtype=`` is, not autocast: every conv and
projector einsum casts its input and its float32 weights to
``compute_dtype``; LayerNorm computes its statistics and affine in float32
and casts back; the final embedding is float32.  Parameters stay float32.

A norm and its activation that need no gradient (grad mode off, or
neither the input nor the norm's parameters require one: serving,
validation) run as ``models/norm_act.py``'s ``norm_act`` over the conv's
output in place: one kernel on the card, its plain version on the CPU;
with autograd (training steps, saliency) they run as the torch ops below.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pfann_tpu_torch.models.norm_act import ACTIVATIONS, norm_act


def _same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    """Keras-style SAME padding (asymmetric)."""
    pad = (size - 1) // s * s + k - size
    return (pad // 2, pad - pad // 2)


class FullLayerNorm(nn.Module):
    """LayerNorm over the entire (C, F, T) volume with an elementwise
    affine; statistics in float32, output in the input's dtype."""

    def __init__(self, shape: tuple[int, int, int], eps: float = 1e-5):
        super().__init__()
        self.shape = shape
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(shape))
        self.bias = nn.Parameter(torch.zeros(shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.shape, self.weight, self.bias, self.eps)
        return y.to(x.dtype)


def _needs_grad(ln: FullLayerNorm, x: torch.Tensor) -> bool:
    """Whether autograd would record the norm: grad mode on, and x or the
    norm's parameters require a gradient."""
    return torch.is_grad_enabled() and (
        x.requires_grad or ln.weight.requires_grad or ln.bias.requires_grad)


class SeparableConv(nn.Module):
    """One encoder block; input/output [B, C, F, T]."""

    def __init__(
        self, in_ch: int, out_ch: int, k: int, stride_t: int, stride_f: int,
        in_F: int, in_T: int, fuller: bool = False, activation: str = "ReLU",
        relu_after_bn: bool = True,
    ):
        super().__init__()
        out_T = (in_T - 1) // stride_t + 1
        out_F = (in_F - 1) // stride_f + 1
        if activation not in ACTIVATIONS:
            raise KeyError(activation)
        self.activation = activation
        self.relu_after_bn = relu_after_bn
        self.pad_t = _same_pad(in_T, k, stride_t)
        self.pad_f = _same_pad(in_F, k, stride_f)
        self.conv1 = nn.Conv2d(in_ch, out_ch, (1, k), stride=(1, stride_t))
        self.ln1 = FullLayerNorm((out_ch, in_F, out_T))
        self.conv2 = nn.Conv2d(
            out_ch, out_ch, (k, 1), stride=(stride_f, 1),
            groups=1 if fuller else out_ch,
        )
        self.ln2 = FullLayerNorm((out_ch, out_F, out_T))

    @staticmethod
    def _conv(conv: nn.Conv2d, x: torch.Tensor, pad: tuple) -> torch.Tensor:
        dt = x.dtype
        w, b = conv.weight.to(dt), conv.bias.to(dt)
        if dt == torch.bfloat16 and x.device.type == "cpu":
            # the CPU's bf16 conv kernels (oneDNN) return wrong values for
            # some of these shapes; sum the bf16 operands in f32 and round
            # once, as XLA's CPU backend does
            return F.conv2d(
                F.pad(x, pad).float(), w.float(), b.float(),
                stride=conv.stride, groups=conv.groups,
            ).to(dt)
        return F.conv2d(F.pad(x, pad), w, b, stride=conv.stride, groups=conv.groups)

    def _norm_act(self, ln: FullLayerNorm, x: torch.Tensor) -> torch.Tensor:
        if not _needs_grad(ln, x):
            # x is the conv's output, which nothing else reads
            return norm_act(x, ln.weight, ln.bias, ln.eps, self.activation,
                            self.relu_after_bn)
        act = ACTIVATIONS[self.activation]
        return act(ln(x)) if self.relu_after_bn else ln(act(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._norm_act(self.ln1, self._conv(self.conv1, x, self.pad_t))
        return self._norm_act(
            self.ln2, self._conv(self.conv2, x, (0, 0) + self.pad_f)
        )


class Encoder(nn.Module):
    """The 8-block conv stack: [B, F, T] -> [B, h], (F, T) reduced to 1x1."""

    def __init__(
        self, d: int, h: int, in_F: int, in_T: int, fuller: bool = False,
        activation: str = "ReLU", strides: Sequence | None = None,
        relu_after_bn: bool = True,
    ):
        super().__init__()
        self.h = h
        channels = [1, d, d, 2 * d, 2 * d, 4 * d, 4 * d, h, h]
        self.blocks: list[SeparableConv] = []
        for i in range(8):
            if strides is not None:
                # config format: strides[i] = [[1, s_t], [s_f, 1]]
                s_t, s_f = strides[i][0][1], strides[i][1][0]
            else:
                s_t, s_f = 2, 2
            block = SeparableConv(
                channels[i], channels[i + 1], 3, s_t, s_f, in_F, in_T,
                fuller=fuller, activation=activation,
                relu_after_bn=relu_after_bn,
            )
            # named block{i}, as the flax tree names them
            self.add_module("block%d" % i, block)
            self.blocks.append(block)
            in_F = (in_F - 1) // s_f + 1
            in_T = (in_T - 1) // s_t + 1
        if not in_F == in_T == 1:
            raise ValueError("strides must reduce (F, T) to 1x1")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x[:, None]
        for block in self.blocks:
            x = block(x)
        return x.reshape(x.shape[0], self.h)


class Projector(nn.Module):
    """Grouped split-FC projector: h -> d groups of (v -> u -> 1), ELU
    between, optional L2 norm.  Weights are the flax einsum weights."""

    def __init__(self, d: int, h: int, u: int):
        super().__init__()
        if h % d:
            raise ValueError("h must be divisible by d")
        self.d, self.v = d, h // d
        self.w1 = nn.Parameter(torch.empty(d, self.v, u))
        self.b1 = nn.Parameter(torch.zeros(d, u))
        self.w2 = nn.Parameter(torch.empty(d, u, 1))
        self.b2 = nn.Parameter(torch.zeros(d, 1))
        nn.init.normal_(self.w1, std=self.v ** -0.5)
        nn.init.normal_(self.w2, std=u ** -0.5)

    def forward(self, x: torch.Tensor, norm: bool = True) -> torch.Tensor:
        dt = x.dtype
        x = x.reshape(-1, self.d, self.v)
        x = torch.einsum("bdv,dvu->bdu", x, self.w1.to(dt)) + self.b1.to(dt)
        x = F.elu(x)
        x = torch.einsum("bdu,duo->bdo", x, self.w2.to(dt)) + self.b2.to(dt)
        x = x.reshape(-1, self.d).float()
        if norm:
            x = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)
        return x


class FpNetwork(nn.Module):
    """log-mel [B, F, T] -> L2-normalized embedding [B, d] float32."""

    def __init__(
        self, d: int, h: int, u: int, F: int, T: int, fuller: bool = False,
        activation: str = "ReLU", strides: Sequence | None = None,
        relu_after_bn: bool = True, compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.d, self.F, self.T = d, F, T
        self.compute_dtype = compute_dtype
        self.f = Encoder(d, h, F, T, fuller=fuller, activation=activation,
                         strides=strides, relu_after_bn=relu_after_bn)
        self.g = Projector(d, h, u)

    def forward(self, x: torch.Tensor, norm: bool = True) -> torch.Tensor:
        return self.g(self.f(x.to(self.compute_dtype)), norm=norm)


def build_fp_network(
    params: dict[str, Any], compute_dtype: torch.dtype = torch.float32
) -> FpNetwork:
    """Build from a pfann-style config dict (F = n_mels, T =
    ceil(segment_size * sample_rate / stft_hop))."""
    model_params = params["model"]
    segn = int(params["segment_size"] * params["sample_rate"])
    T = (segn + params["stft_hop"] - 1) // params["stft_hop"]
    return FpNetwork(
        d=model_params["d"],
        h=model_params["h"],
        u=model_params["u"],
        F=params["n_mels"],
        T=T,
        fuller=model_params.get("fuller", False),
        activation=model_params.get("conv_activation", "ReLU"),
        strides=model_params.get("strides"),
        relu_after_bn=model_params.get("relu_after_bn", True),
        compute_dtype=compute_dtype,
    )


def _lecun_normal_(p: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's ``lecun_normal``: a normal truncated at two standard deviations,
    scaled so its variance is 1 / fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    t = torch.empty(p.shape)
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    p.copy_(t)


@torch.no_grad()
def init_like_flax(model: FpNetwork, generator: torch.Generator) -> None:
    """Re-initialise ``model`` with the initialisers of the JAX FpNetwork
    (``pfann_tpu/models/fp_network.py``): ``lecun_normal`` for every conv
    kernel (fan-in = in_channels / groups * kh * kw) and for the projector's
    ``w1``/``w2`` (``batch_axis=(0,)``, so fan-in = shape[1]), zeros for the
    biases, ones and zeros for the LayerNorm affine.  Draws come from the
    CPU ``generator``, so a seed gives the same weights on every device."""
    for name, p in model.named_parameters():
        kind = name.rsplit(".", 2)
        if name in ("g.w1", "g.w2"):
            _lecun_normal_(p, p.shape[1], generator)
        elif kind[-2].startswith("conv") and kind[-1] == "weight":
            _lecun_normal_(p, p[0].numel(), generator)
        elif kind[-2].startswith("ln") and kind[-1] == "weight":
            p.fill_(1.0)
        else:
            p.zero_()
