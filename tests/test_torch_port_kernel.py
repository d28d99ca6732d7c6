"""The align-reduce kernel module, without JAX.

This file imports no jax, so it also runs on a machine with a card and no
JAX package.  There ``tests/conftest.py`` (which imports jax) is skipped:

    python -m pytest tests/test_torch_port_kernel.py --noconftest -p no:cacheprovider

On the CPU the plain version is held to the kernel's definition in
float64; tests marked ``cuda`` compare the hand-written kernel with the
plain version on the card and skip where no card is visible.

Tolerances: plain version vs float64 definition atol 1e-5 (f32 sums of up
to S*d = 4k terms of magnitude <= 1/d); kernel vs plain version atol 1e-3
on the card (the same f32 sums in other orders), offsets equal wherever
the runner-up offset is more than that below the best.
"""

import numpy as np
import pytest
import torch

from pfann_tpu_torch.index import align_kernel
from pfann_tpu_torch.index.align import build_uniform_layout
from pfann_tpu_torch.index.align_kernel import align_reduce, align_reduce_reference


def _corpus(rng, counts, d):
    emb = rng.standard_normal((int(np.sum(counts)), d)).astype(np.float32)
    return emb / np.linalg.norm(emb, axis=1, keepdims=True)


def _definition(db, qs, R, S, n_songs):
    """float64 align [B, n_songs, R]: sum_i db[s*R + o + i] . q[b, i], rows
    past the end of db read as zero."""
    N0 = n_songs * R
    dbp = np.concatenate([db, np.zeros((max(0, N0 + S - 1 - len(db)), db.shape[1]))])
    out = np.zeros((qs.shape[0], N0))
    for i in range(S):
        out += qs[:, i].astype(np.float64) @ dbp[i : N0 + i].T.astype(np.float64)
    return out.reshape(qs.shape[0], n_songs, R)


def _last_argmax(a):
    return a.shape[-1] - 1 - np.argmax(a[..., ::-1], axis=-1)


@pytest.mark.parametrize("pad,S,B,trailing", [
    (32, 19, 5, True), (32, 32, 9, False), (8, 1, 3, True), (128, 119, 2, False)])
def test_reference_matches_definition(pad, S, B, trailing):
    """Plain version == the definition, also when the layout has no
    trailing pad rows (rows >= N read as zero) and at S = 119."""
    rng = np.random.default_rng(S)
    d = 16
    counts = rng.integers(5, 140, size=6)
    db, R = build_uniform_layout(_corpus(rng, counts, d), counts, pad=pad,
                                 trailing_pad=trailing)
    qs = (rng.standard_normal((B, S, d)) / np.sqrt(d)).astype(np.float32)
    best, off = align_reduce(torch.from_numpy(db), torch.from_numpy(qs), R, S, 6)
    want = _definition(db, qs, R, S, 6)
    assert best.shape == off.shape == (B, 6)
    np.testing.assert_allclose(best.numpy(), want.max(axis=2), rtol=0, atol=1e-5)
    top2 = np.sort(want, axis=2)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-5
    np.testing.assert_array_equal(off.numpy()[clear], _last_argmax(want)[clear])
    assert align_reduce.launches == 0  # CPU tensors never reach the kernel


def test_reference_chunks_queries(monkeypatch):
    """The plain version's B-chunking (bounded score tensor) changes nothing."""
    rng = np.random.default_rng(1)
    counts = np.asarray([30, 12, 44])
    db, R = build_uniform_layout(_corpus(rng, counts, 8), counts, pad=16)
    qs = torch.from_numpy(rng.standard_normal((7, 10, 8)).astype(np.float32))
    whole = align_reduce_reference(torch.from_numpy(db), qs, R, 10, 3)
    monkeypatch.setattr(align_kernel, "REFERENCE_SCORE_BYTES", 1)
    chunked = align_reduce_reference(torch.from_numpy(db), qs, R, 10, 3)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def test_reference_empty_inputs():
    db = torch.zeros(40, 4)
    best, off = align_reduce(db, torch.zeros(0, 3, 4), 10, 3, 2)
    assert best.shape == off.shape == (0, 2)
    best, off = align_reduce(db, torch.zeros(2, 3, 4), 10, 3, 0)
    assert best.shape == off.shape == (2, 0)


def _int8_case(rng, S, B, d=128, n_songs=9, pad=32):
    """An int8 layout and queries [B, S, d] of +-127-scale values.  Query 0
    is a copy of song 0's window at offset pad + 2 (a row sum of ~S*d*127^2,
    past 2^24 at S = 30), and offset pad + S + 10 holds the same window less
    1 (one element where the query is 1 lowered by 1): an f32 sum would tie
    the two and keep the later offset, the int32 sum keeps the earlier."""
    counts = np.full(n_songs, 2 * S + 20)
    R = pad + int(counts.max())
    db = np.zeros((n_songs * R + pad, d), np.int8)
    db[: n_songs * R] = rng.integers(-127, 128, size=(n_songs * R, d))
    for s in range(n_songs):
        db[s * R : s * R + pad] = 0
    qs = rng.integers(-127, 128, size=(B, S, d)).astype(np.int8)
    win = np.where(rng.random((S, d)) < 0.5, -127, 127).astype(np.int8)
    win[S // 2, 3] = 1
    o1, o2 = pad + 2, pad + S + 10
    db[o1 : o1 + S] = win
    db[o2 : o2 + S] = win
    db[o2 + S // 2, 3] = 0
    qs[0] = win
    return db, qs, R, n_songs, (o1, o2)


def _int8_definition(db, qs, R, S, n_songs):
    """int64 align [B, n_songs, R]: the exact int8 x int8 sums."""
    N0 = n_songs * R
    dbp = np.concatenate([db, np.zeros((max(0, N0 + S - 1 - len(db)), db.shape[1]),
                                       db.dtype)]).astype(np.int64)
    out = np.zeros((qs.shape[0], N0), np.int64)
    for i in range(S):
        out += qs[:, i].astype(np.int64) @ dbp[i : N0 + i].T
    return out.reshape(qs.shape[0], n_songs, R)


@pytest.mark.parametrize("S,B", [(5, 3), (8, 2), (30, 4)])
def test_int8_reference_matches_int64_definition(S, B):
    """The int8 plain version is exact: best is the int64 row sum rounded
    once to f32, argoff the last offset reaching the int64 max, also where
    sums pass 2^24 (S = 30) and differ by 1 there."""
    rng = np.random.default_rng(S)
    db, qs, R, n_songs, (o1, o2) = _int8_case(rng, S, B)
    best, off = align_reduce(torch.from_numpy(db), torch.from_numpy(qs), R, S, n_songs)
    want = _int8_definition(db, qs, R, S, n_songs)
    assert best.dtype == torch.float32 and off.dtype == torch.int32
    np.testing.assert_array_equal(best.numpy(), want.max(axis=2).astype(np.float32))
    np.testing.assert_array_equal(off.numpy(), _last_argmax(want))
    assert off[0, 0] == o1 and want[0, 0, o1] - want[0, 0, o2] == 1
    if S == 30:
        assert want[0, 0, o1] > 2**24
        assert np.float32(want[0, 0, o1]) == np.float32(want[0, 0, o2])
    assert align_reduce.launches == 0


def test_nvcc_missing_raises(monkeypatch, tmp_path):
    """No nvcc, no kernel: the build raises instead of falling back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(align_kernel, "BUILD_DIR", str(tmp_path / "build"))
    if align_kernel.shutil.which("nvcc") or align_kernel.os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        pytest.skip("an nvcc is installed at the default location")
    with pytest.raises(RuntimeError, match="nvcc"):
        align_kernel.build()


# ----------------------------------------------------------------- on a card
@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad,S,B", [(32, 19, 1), (32, 32, 100), (128, 119, 70)])
def test_kernel_matches_plain_on_card(cuda_device, dtype, pad, S, B):
    rng = np.random.default_rng(S * B)
    d = 128
    counts = rng.integers(40, 121, size=57)
    db, R = build_uniform_layout(_corpus(rng, counts, d), counts, pad=pad,
                                 trailing_pad=pad == 32)
    qs = (rng.standard_normal((B, S, d)) / np.sqrt(d)).astype(np.float32)
    dbt = torch.from_numpy(db).to(cuda_device, dtype)
    qt = torch.from_numpy(qs).to(cuda_device, dtype)
    before = align_reduce.launches
    kb, ko = align_reduce(dbt, qt, R, S, len(counts))
    torch.cuda.synchronize()
    assert align_reduce.launches == before + 1
    pb, po = align_reduce_reference(dbt, qt, R, S, len(counts))
    np.testing.assert_allclose(kb.cpu().numpy(), pb.cpu().numpy(), rtol=0, atol=1e-3)
    want = _definition(dbt.float().cpu().numpy(), qt.float().cpu().numpy(), R, S,
                       len(counts))
    top2 = np.sort(want, axis=2)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2e-3
    np.testing.assert_array_equal(ko.cpu().numpy()[clear], po.cpu().numpy()[clear])


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda_device):
    db = torch.zeros(40, 8, device=cuda_device)
    with pytest.raises(TypeError):
        align_reduce(db, torch.zeros(2, 3, 8, device=cuda_device).half(), 10, 3, 2)
    with pytest.raises(ValueError):
        align_reduce(db, torch.zeros(2, 4, 8, device=cuda_device), 10, 3, 2)
    with pytest.raises(ValueError):
        align_reduce(db, torch.zeros(2, 3, 8), 10, 3, 2)
    with pytest.raises(ValueError):
        align_reduce(db.t(), torch.zeros(2, 3, 40, device=cuda_device), 10, 3, 2)
    with pytest.raises(ValueError, match="multiple of 4"):
        align_reduce(torch.zeros(40, 6, device=cuda_device),
                     torch.zeros(2, 3, 6, device=cuda_device), 10, 3, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("S,B", [(5, 1), (6, 100), (8, 64), (30, 130)])
def test_int8_kernel_matches_plain_on_card(cuda_device, S, B):
    """int8 kernel == plain version, bitwise in best and argoff (both exact:
    int32 sums in the kernel, float64 in the plain version)."""
    rng = np.random.default_rng(S * B)
    db, qs, R, n_songs, (o1, _) = _int8_case(rng, S, B, n_songs=57)
    dbt = torch.from_numpy(db).to(cuda_device)
    qt = torch.from_numpy(qs).to(cuda_device)
    before = dict(align_reduce.launches_by_dtype)
    kb, ko = align_reduce(dbt, qt, R, S, n_songs)
    torch.cuda.synchronize()
    assert align_reduce.launches_by_dtype[torch.int8] == before[torch.int8] + 1
    assert align_reduce.launches_by_dtype[torch.bfloat16] == before[torch.bfloat16]
    pb, po = align_reduce_reference(dbt, qt, R, S, n_songs)
    assert torch.equal(kb, pb) and torch.equal(ko, po)
    assert ko[0, 0].item() == o1


@pytest.mark.cuda
def test_kernel_int8_rejects_bad_inputs(cuda_device):
    db = torch.zeros(40, 6, dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 4"):
        align_reduce(db, torch.zeros(2, 3, 6, dtype=torch.int8, device=cuda_device),
                     10, 3, 2)
    flat = torch.zeros(40 * 8 + 1, dtype=torch.int8, device=cuda_device)
    q = torch.zeros(2, 3, 8, dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        align_reduce(flat[1:].view(40, 8), q, 10, 3, 2)  # one byte off
    with pytest.raises(TypeError):
        align_reduce(flat[:320].view(40, 8), q.float(), 10, 3, 2)
