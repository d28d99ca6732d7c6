"""The norm-and-activation kernel's plain version, plan and dispatch on the CPU.

``models/norm_act.py`` runs FpNetwork's whole-volume LayerNorm and its
activation as one kernel on the card (tests/test_torch_port_card.py holds
the kernel to the plain version there).  Here: the plain version equals the
torch path ``SeparableConv`` keeps for autograd (``FullLayerNorm`` and the
activation) bit for bit, at every norm volume of the d=128 encoder and of
pfann's n640d64 (d=64, depthwise), for ReLU and ELU, both orders, bf16 and
f32; the plan covers every volume and refuses a segment that is not whole
16-byte vectors; and the dispatch rule: a call that needs no gradient
(serving, validation) goes through ``norm_act``, which on a CPU tensor runs
the plain version and never loads or launches the kernel; a call that needs
a gradient (the Trainer's step, saliency) takes the torch ops, and
gradients through them are the torch ops' own.
"""

import functools
import re

import numpy as np
import pytest
import torch

from pfann_tpu_torch.index.embedder import Embedder
from pfann_tpu_torch.models import fp_network
from pfann_tpu_torch.models import norm_act as na
from pfann_tpu_torch.models.fp_network import build_fp_network
from pfann_tpu_torch.train.trainer import Trainer
from pfann_tpu_torch.utils.checkpoint import save_model

BASE = {
    "sample_rate": 8000, "stft_n": 1024, "stft_hop": 256, "n_mels": 256,
    "f_min": 300, "f_max": 4000, "segment_size": 1, "hop_size": 0.5,
}
# the benchmark's d=128 encoder (configs/default.json) and pfann's n640d64
ENCODERS = {
    "d128": {"d": 128, "h": 1024, "u": 32, "fuller": True},
    "n640d64": {"d": 64, "h": 1024, "u": 32, "fuller": False},
}
TINY = dict(BASE, model={"d": 16, "h": 64, "u": 8, "fuller": True}, batch_size=8, lr=1e-3,
            tau=0.05, cutout_min=0.1, cutout_max=0.5, model_dir=None, shuffle_size=None,
            epoch=1)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _blocks(encoder, activation, relu_after_bn):
    cfg = dict(BASE, model=dict(ENCODERS[encoder], conv_activation=activation,
                                relu_after_bn=relu_after_bn))
    return build_fp_network(cfg).f.blocks


def _norms(blocks):
    return [(b, ln) for b in blocks for ln in (b.ln1, b.ln2)]


def test_sixteen_norm_volumes_an_encoder():
    vols = {e: [int(np.prod(ln.shape)) for _, ln in _norms(_blocks(e, "ReLU", True))]
            for e in ENCODERS}
    assert len(vols["d128"]) == len(vols["n640d64"]) == 16
    # the volumes the card's kernel runs a segment of a d=128 batch
    assert sum(vols["d128"]) == 1_133_568
    assert vols["d128"][:2] == [524_288, 262_144] and vols["d128"][-1] == 1_024


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("order", ["act_after", "act_first"])
@pytest.mark.parametrize("activation", ["ReLU", "ELU"])
@pytest.mark.parametrize("encoder", list(ENCODERS))
def test_plain_equals_torch_path(encoder, activation, order, dtype):
    """norm_act_reference against FullLayerNorm and the activation as
    SeparableConv runs them on the CPU: bit for bit at all 16 volumes."""
    relu_after_bn = order == "act_after"
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(7)
    for block, ln in _norms(_blocks(encoder, activation, relu_after_bn)):
        x = (torch.randn((2, *ln.shape), generator=g) * 1.7 + 0.3).to(dt)
        w = 1 + 0.2 * torch.randn(ln.shape, generator=g)
        b = 0.1 * torch.randn(ln.shape, generator=g)
        with torch.no_grad():
            ln.weight.copy_(w)
            ln.bias.copy_(b)
            want = block._norm_act(ln, x.clone())
            act = na.ACTIVATIONS[block.activation]
            explicit = act(ln(x)) if relu_after_bn else ln(act(x))
        got = na.norm_act_reference(x, w, b, ln.eps, activation, relu_after_bn)
        assert got.dtype == want.dtype == dt
        assert torch.equal(got, want) and torch.equal(got, explicit), (encoder, ln.shape)
        # the wrapper on a CPU tensor: the plain version, written over x
        y = x.clone()
        assert na.norm_act(y, w, b, ln.eps, activation, relu_after_bn) is y
        assert torch.equal(y, want)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_plan_holds_every_volume(itemsize):
    vec = 16 // itemsize
    vols = {int(np.prod(ln.shape)) for e in ENCODERS for _, ln in _norms(_blocks(e, "ReLU", True))}
    for V in sorted(vols | {8, 1000, 123_456, 1 << 22}):
        assert V % vec == 0
        p = na.plan(V, itemsize)
        nv = V // vec
        if p["form"] == "rows":
            G = p["G"]
            assert (p["vpt"], p["segs"]) in na.ROWS_TILES
            assert 32 <= G <= na.THREADS and G & (G - 1) == 0
            assert G * p["vpt"] >= nv and nv <= na.ROWS_MAX
            # no thread left without a vector where a smaller group would do
            assert G == 32 or (G // 2) * p["vpt"] < nv
        else:
            assert p == dict(form="split") and nv > na.ROWS_MAX
    # the kernel moves whole 16-byte vectors: other volumes are refused
    for V in (0, 1, 5, vec - 1, vec + 2, 123_457):
        with pytest.raises(ValueError, match="16-byte"):
            na.plan(V, itemsize)
    # the d=128 encoder in bf16: the five largest volumes split, the rest rows
    forms = [na.plan(int(np.prod(ln.shape)), 2)["form"]
             for _, ln in _norms(_blocks("d128", "ReLU", True))]
    if itemsize == 2:
        assert forms == ["split"] * 5 + ["rows"] * 11


def test_rows_tiles_are_the_sources():
    """ROWS_TILES lists the (VPT, S) tiles csrc/norm_act.cu instantiates."""
    with open(na.SOURCE) as f:
        src = f.read()
    line = re.search(r"#define NA_ROWS_TILES\(X\)(.*)", src).group(1)
    assert tuple((int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", line)) == \
        na.ROWS_TILES
    assert "constexpr int THREADS = %d;" % na.THREADS in src
    assert "constexpr int STATS_VPT = %d;" % na.STATS_VPT in src
    assert "constexpr int SPB = 16;" in src


def test_needs_grad_rule():
    ln = fp_network.FullLayerNorm((2, 3, 4))
    x = torch.randn(1, 2, 3, 4)
    assert fp_network._needs_grad(ln, x)  # parameters require grad
    with torch.no_grad():
        assert not fp_network._needs_grad(ln, x)
    with torch.inference_mode():
        assert not fp_network._needs_grad(ln, x)
    ln.requires_grad_(False)
    assert not fp_network._needs_grad(ln, x)
    assert fp_network._needs_grad(ln, x.requires_grad_(True))
    with torch.no_grad():
        assert not fp_network._needs_grad(ln, x)


@pytest.fixture()
def recorded(monkeypatch):
    """Every _needs_grad answer, and after each answer of False one call of
    norm_act (``None`` in the list), with the kernel's loader made to
    fail."""
    seen = []
    real, real_norm_act = fp_network._needs_grad, fp_network.norm_act

    def record(ln, x):
        seen.append(real(ln, x))
        return seen[-1]

    def record_norm_act(x, *args):
        assert x.device.type == "cpu"
        seen.append(None)
        return real_norm_act(x, *args)

    def no_load():
        raise AssertionError("a CPU call loaded the norm_act kernel")

    monkeypatch.setattr(fp_network, "_needs_grad", record)
    monkeypatch.setattr(fp_network, "norm_act", record_norm_act)
    monkeypatch.setattr(na, "_load", no_load)
    start = na.launches
    yield seen
    assert na.launches == start


@pytest.fixture()
def embedder(tmp_path):
    torch.manual_seed(0)
    path = str(tmp_path / "model.msgpack")
    save_model(path, build_fp_network(TINY).state_dict())
    return Embedder(TINY, path, "cpu", compute_dtype=torch.float32, chunk=4)


def test_serving_needs_no_grad_and_saliency_does(recorded, embedder):
    """Embedder.embed goes through norm_act (the kernel on the card) and
    embed_with_saliency through the torch ops: here every norm of the
    first asks for no gradient and calls norm_act, and every one of the
    second asks for one; neither loads the kernel on the CPU."""
    wav = np.random.default_rng(0).standard_normal((3, 8000)).astype(np.float32)
    embedder.embed(wav)
    assert recorded == [False, None] * 16
    recorded.clear()
    embedder.embed_with_saliency(wav)
    assert recorded == [True] * 16


def test_trainer_step_needs_grad_and_validation_does_not(recorded):
    tr = Trainer(TINY, compute_dtype=torch.float32, device="cpu")
    tr.init_state()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((8, 256, 32)).astype(
        np.float32))
    draws = tr.specaug.draw(torch.Generator().manual_seed(0), 256, 32)
    assert torch.isfinite(tr.train_step(x, draws))
    assert recorded == [True] * 16
    recorded.clear()
    tr._embed_all([x.numpy()])
    assert recorded == [False, None] * 16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradients_through_torch_path_are_the_torch_ops(recorded, dtype):
    """Gradients of an encoder through SeparableConv equal those of the
    same blocks run with FullLayerNorm and the activation written out."""
    cfg = dict(BASE, model={"d": 16, "h": 64, "u": 8, "fuller": False,
                            "conv_activation": "ELU"})
    torch.manual_seed(3)
    model = build_fp_network(cfg, compute_dtype=getattr(torch, dtype))
    mel = torch.randn(4, 256, 32)

    def explicit(x):
        x = x.to(model.compute_dtype)[:, None]
        for blk in model.f.blocks:
            act = na.ACTIVATIONS[blk.activation]
            x = act(blk.ln1(blk._conv(blk.conv1, x, blk.pad_t)))
            x = act(blk.ln2(blk._conv(blk.conv2, x, (0, 0) + blk.pad_f)))
        return model.g(x.reshape(x.shape[0], model.f.h))

    grads = []
    for fn in (model, explicit):
        model.zero_grad(set_to_none=True)
        g = mel.clone().requires_grad_(True)
        out = fn(g)
        (dg,) = torch.autograd.grad(out.square().sum(), g, retain_graph=True)
        out.square().sum().backward()
        grads.append([dg] + [p.grad.clone() for p in model.parameters()])
    assert recorded and all(recorded)
    for a, b in zip(*grads):
        assert torch.equal(a, b)
