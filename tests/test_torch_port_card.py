"""The engines and paths that run as torch ops on the card (no align-reduce
kernel): the score_alpha paths of the exhaustive and screened engines,
the topk engine, the long-query fallback and the saliency gradient, each
on a card against the same code on the CPU.

Like tests/test_torch_port_kernel.py this file imports no jax, so it runs
on a machine with a card and no JAX package:

    python -m pytest tests/test_torch_port_kernel.py tests/test_torch_port_card.py \
        --noconftest -p no:cacheprovider

Every test is marked ``cuda`` and skips where no card is visible.

Tolerances (card against CPU, the same f32 sums in other orders, TF32
off): alpha best sums atol 2e-3 (BEST_ATOL) and offsets equal where the
runner-up scores more than that below; topk song maxima atol 1e-5 and
times equal; answers (song, time) equal; saliency embeddings within 1e-4
and the gradient within 5e-2 of each (segment, frame) column's max |dg|
on >= 99% of entries, in f32.
"""

import os

import numpy as np
import pytest
import torch

from pfann_tpu_torch.index import align_kernel
from pfann_tpu_torch.index.align import AlignmentEngine
from pfann_tpu_torch.index.align_kernel import align_reduce
from pfann_tpu_torch.index.database import Database, write_index_meta
from pfann_tpu_torch.index.embedder import Embedder
from pfann_tpu_torch.index.screen import ScreenedAlignmentEngine
from pfann_tpu_torch.index.search import TopkEngine
from pfann_tpu_torch.models.fp_network import build_fp_network
from pfann_tpu_torch.utils.checkpoint import save_model

BEST_ATOL = 2e-3
TINY_MODEL = {
    "sample_rate": 8000, "stft_n": 1024, "stft_hop": 256, "n_mels": 256,
    "f_min": 300, "f_max": 4000, "segment_size": 1, "hop_size": 0.5,
    "model": {"d": 16, "h": 64, "u": 8, "fuller": True},
}


@pytest.fixture()
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: these paths are checked on one against the CPU")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)

    plain = align_kernel.align_reduce_reference

    def cpu_only_plain(db, *a, **k):
        if db.device.type != "cpu":
            raise AssertionError("a card path reached align_reduce_reference")
        return plain(db, *a, **k)

    monkeypatch.setattr(align_kernel, "align_reduce_reference", cpu_only_plain)
    yield torch.device("cuda")
    # the kernel file's CPU tests count from 0 in the same process
    align_kernel.reset_launch_counts()


def _corpus(rng, n_songs, d, lo=20, hi=60):
    counts = rng.integers(lo, hi, size=n_songs)
    emb = rng.standard_normal((int(counts.sum()), d)).astype(np.float32)
    return emb / np.linalg.norm(emb, axis=1, keepdims=True), counts


def _crops(rng, emb, counts, n, S, noise=0.1):
    """n noisy crops of S rows of random songs: (queries [n, S, d], song)."""
    pos = np.pad(np.cumsum(counts), (1, 0))
    src = rng.integers(0, len(counts), size=n)
    q = np.zeros((n, S, emb.shape[1]), np.float32)
    for i, s in enumerate(src):
        t = rng.integers(0, counts[s] - S + 1) if counts[s] >= S else 0
        rows = emb[pos[s] + t : pos[s] + min(t + S, counts[s])]
        q[i, : len(rows)] = rows
    q += noise * rng.standard_normal(q.shape).astype(np.float32)
    return q / np.linalg.norm(q, axis=2, keepdims=True), src


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_alpha_exhaustive_engine_on_card(cuda_device, dtype):
    """score_alpha runs as torch ops on the card: no kernel launch, no plain
    version, the CPU path's best sums and offsets, with short filters
    (sub_lens) masked."""
    rng = np.random.default_rng(1)
    emb, counts = _corpus(rng, 40, 32)
    q, _ = _crops(rng, emb, counts, 50, 12)
    lens = rng.integers(6, 13, size=50)
    for i, n in enumerate(lens):
        q[i, n:] = 0
    before = align_reduce.launches
    (gs, gt), (cs, ct) = (
        AlignmentEngine(emb, counts, pad=16, score_dtype=dtype, device=dev,
                        score_alpha=1.5).search(q, lens)
        for dev in (cuda_device, "cpu"))
    assert align_reduce.launches == before
    np.testing.assert_allclose(gs, cs, rtol=0, atol=BEST_ATOL / 6)
    top2 = np.sort(cs, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > BEST_ATOL
    assert clear.any()
    np.testing.assert_array_equal(gs.argmax(1)[clear], cs.argmax(1)[clear])
    assert (gt != ct).mean() < 0.01  # offsets differ only at near-ties


@pytest.mark.cuda
def test_alpha_screened_engine_on_card(cuda_device):
    """The screened engine with score_alpha on the card: stage 1 launches
    the int8 kernel, stage 2 and the rescue run as torch ops (no bf16
    launch); the answers equal the CPU engine's."""
    rng = np.random.default_rng(2)
    emb, counts = _corpus(rng, 60, 32)
    q, src = _crops(rng, emb, counts, 40, 12, noise=0.3)
    kw = dict(pad=16, k=4, top_m=8, coarse_dtype="int8", score_alpha=1.0,
              rescue_threshold=0.9)
    card = ScreenedAlignmentEngine(emb, counts, device=cuda_device, **kw)
    cpu = ScreenedAlignmentEngine(emb, counts, device="cpu", **kw)
    before = dict(align_reduce.launches_by_dtype)
    gsong, gbest, gt = card.search_top1(q)
    assert align_reduce.launches_by_dtype[torch.int8] > before[torch.int8]
    assert align_reduce.launches_by_dtype[torch.bfloat16] == before[torch.bfloat16]
    assert card.escalated > 0  # the alpha rescue ran
    csong, cbest, ct = cpu.search_top1(q)
    np.testing.assert_allclose(gbest, cbest, rtol=0, atol=BEST_ATOL)
    np.testing.assert_array_equal(gsong, csong)
    np.testing.assert_array_equal(gt, ct)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,fsm,alpha", [
    (torch.float32, 1, 0.0), (torch.bfloat16, 1, 0.0), (torch.bfloat16, 2, 1.5),
])
def test_topk_engine_on_card(cuda_device, dtype, fsm, alpha):
    """TopkEngine on the card against the CPU: the same candidates, song
    maxima within f32 rounding, the same times; padded rows add nothing."""
    rng = np.random.default_rng(3)
    emb, counts = _corpus(rng, 30, 32)
    pos = np.pad(np.cumsum(counts), (1, 0))
    q, _ = _crops(rng, emb, counts, 9, 24)
    queries = [q[i, : 10 + 2 * i] for i in range(9)]
    before = align_reduce.launches
    (gm, gt), (cm, ct) = (
        TopkEngine(emb, pos, top_k=5, frame_shift_mul=fsm, score_alpha=alpha,
                   score_dtype=dtype, device=dev).search(queries)
        for dev in (cuda_device, "cpu"))
    assert align_reduce.launches == before
    np.testing.assert_array_equal(np.isfinite(gm), np.isfinite(cm))
    hit = np.isfinite(cm)
    np.testing.assert_allclose(gm[hit], cm[hit], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(gt, ct)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["align", "screen", "topk"])
def test_database_long_queries_on_card(cuda_device, tmp_path, engine):
    """Queries longer than the layout pad (8 windows) take the topk
    fallback on the card, launching no align-reduce kernel, and give the
    CPU Database's answers; engine topk serves every length so."""
    rng = np.random.default_rng(4)
    emb, counts = _corpus(rng, 25, 32, lo=30, hi=50)
    root = str(tmp_path)
    emb.tofile(os.path.join(root, "embeddings"))
    counts.astype(np.int32).tofile(os.path.join(root, "landmarkKey"))
    with open(os.path.join(root, "songList.txt"), "w") as f:
        f.writelines("s%d.wav\n" % i for i in range(len(counts)))
    write_index_meta(root, d=32, meta={"ntotal": int(counts.sum()), "align_pad": 8})
    params = {"top_k": 6, "engine": engine, "screen_top_m": 4}
    q, src = _crops(rng, emb, counts, 6, 20)
    queries = [q[i, : 12 + i] for i in range(6)]
    before = align_reduce.launches
    got = Database(root, params, 0.5, cuda_device).query_top1_batch(queries)
    assert align_reduce.launches == before
    want = Database(root, params, 0.5, "cpu").query_top1_batch(queries)
    assert [a for _, a in got] == [a for _, a in want]
    assert [a[0] for _, a in got] == list(src)
    np.testing.assert_allclose([s for s, _ in got], [s for s, _ in want], rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_embed_with_saliency_on_card(cuda_device, tmp_path):
    """The saliency gradient (autograd through the model with the
    embedding as cotangent) on the card against the CPU, in f32."""
    torch.manual_seed(0)
    path = str(tmp_path / "model.msgpack")
    save_model(path, build_fp_network(TINY_MODEL).state_dict())
    rng = np.random.default_rng(5)
    segs = rng.standard_normal((5, 8000)).astype(np.float32) * 0.1
    (gz, gdg, gg), (cz, cdg, cg) = (
        Embedder(TINY_MODEL, path, dev, compute_dtype=torch.float32).embed_with_saliency(segs)
        for dev in (cuda_device, "cpu"))
    np.testing.assert_allclose(gz, cz, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gg, cg, rtol=1e-3, atol=2e-3)
    scale = np.maximum(np.abs(cdg).max(axis=1, keepdims=True), 1e-12)
    assert np.mean(np.abs(gdg - cdg) <= 5e-2 * scale) >= 0.99
