"""The engines and paths that run as torch ops on the card (no align-reduce
kernel): the score_alpha paths of the exhaustive and screened engines,
the topk engine, the long-query fallback, the saliency gradient and the
landmark peak extractor, each on a card against the same code on the CPU;
and one traced query an engine, whose kernels (the align-reduce kernel's
among them) fpbench's reading puts down to the program's spans; and the
single-card top-1 path at the benchmark's d = 64 shapes, launched at the
queries' own 19 windows against the bucketed 24, with the kernel at
stage 3's shape held to the plain version on the CPU; and FpNetwork's
norm-and-activation kernel (models/norm_act.py) against its plain version
on the card at every norm volume of two encoders, past 2^32 elements, and
inside FpNetwork, with the paths that need autograd launching none.

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
from pfann_tpu_torch.index.align_kernel import align_reduce, align_reduce_reference
from pfann_tpu_torch.index.database import Database, write_index_meta
from pfann_tpu_torch.index.embedder import Embedder
from pfann_tpu_torch.index.screen import ScreenedAlignmentEngine, build_screen_layout
from pfann_tpu_torch.index.search import TopkEngine
from pfann_tpu_torch.models import norm_act as na
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
    return _corpus_rows(rng, counts, d), counts


def _corpus_rows(rng, counts, d):
    emb = rng.standard_normal((int(counts.sum()), d)).astype(np.float32)
    return emb / np.linalg.norm(emb, axis=1, keepdims=True)


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


def _tone_bursts(seed, seconds, sr=8000):
    """Decaying tone bursts over a 0.01 noise floor (bench.py's landmark
    songs), float32 in [-0.6, 0.6]."""
    r = np.random.default_rng(seed)
    n = int(sr * seconds)
    out = 0.01 * r.standard_normal(n).astype(np.float32)
    t = 0
    while t < n:
        dur = min(int(sr * r.uniform(0.1, 0.4)), n - t)
        tt = np.arange(dur, dtype=np.float32) / sr
        out[t : t + dur] += (r.uniform(0.3, 0.8) * np.sin(2 * np.pi * r.uniform(100, 3500) * tt)
                             * np.exp(-tt * 20)).astype(np.float32)
        t += dur + int(sr * r.uniform(0.05, 0.2))
    return 0.6 * out / max(float(np.abs(out).max()), 1e-9)


@pytest.mark.cuda
def test_peak_extractor_on_card(cuda_device):
    """The landmark front end (torch ops) on the card against the same
    code on the CPU: peaks agree on >= 0.999 of cells (cuFFT and the CPU
    FFT differ in f32 rounding, which can flip a cell at the median gate
    or at a tie in its window).  On the card, an int16 chunk (scaled on
    the device), the same signal as f32 and an int16 member of a mixed
    chunk (rescaled on the host) give the same peaks."""
    from pfann_tpu_torch.landmark.device import DevicePeakExtractor

    wavs = [_tone_bursts(i, s) for i, s in enumerate((30.0, 3.0, 1.3, 5.01, 0.05))]
    wavs.append(np.zeros(400, np.float32))
    card = DevicePeakExtractor(batch=3, pipeline=2, device=cuda_device).extract(wavs)
    cpu = DevicePeakExtractor(batch=3, device="cpu").extract(wavs)
    same = total = 0
    for c, p in zip(card, cpu):
        assert c.dtype == np.int32 and (np.diff(c[:, 1]) >= 0).all()
        a, b = set(map(tuple, c.tolist())), set(map(tuple, p.tolist()))
        same += len(a & b)
        total += max(len(a), len(b))
    assert total > 100 and same >= 0.999 * total, (same, total)

    q = (np.clip(wavs[1], -1, 1) * 32767).astype(np.int16)
    ex = DevicePeakExtractor(batch=2, device=cuda_device)
    as_i16 = ex.extract([q, q])[0]
    as_f32 = ex.extract([q.astype(np.float32) / 32768] * 2)[0]
    mixed = ex.extract([q, wavs[1]])[0]
    assert as_i16.shape[0] > 0
    np.testing.assert_array_equal(as_i16, as_f32)
    np.testing.assert_array_equal(as_i16, mixed)


# ---------------------------------------------------------------- training
TRAIN_CFG = dict(TINY_MODEL, batch_size=16, epoch=2, lr=1e-3, tau=0.05,
                 cutout_min=0.1, cutout_max=0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["adam", "lamb"])
def test_train_step_on_card_matches_cpu(cuda_device, optimizer):
    """One train step in f32 compute, TF32 off, on the card against the
    CPU: the same params (flax-like init from one seed), batch and mask.
    Loss rtol 1e-5; each leaf's grad within 5e-4 of its norm; params after
    the step within 1e-3 * lr on >= 99.9% of entries and 0.5 * lr on all
    (an entry whose grad lies within rounding of 0 moves by a fraction of
    lr in the first Adam/LAMB step)."""
    from pfann_tpu_torch.train.trainer import Trainer
    from pfann_tpu_torch.utils.rng import seeded_generator

    cfg = dict(TRAIN_CFG, optimizer=optimizer)
    x = torch.from_numpy((np.random.default_rng(11).standard_normal((32, 256, 32)) * 2 - 4)
                         .astype(np.float32))
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        tr = Trainer(cfg, compute_dtype=torch.float32, device=dev)
        tr.init_state(seed=5)
        draws = tr.specaug.draw(seeded_generator(123, 0, 0), 256, 32)
        loss = tr.train_step(x.to(dev), draws)
        out[dev.type] = (float(loss), {n: p.grad.cpu() for n, p in tr.model.named_parameters()},
                         {n: t.cpu() for n, t in tr.model.state_dict().items()})
    (lc, gc, pc), (lg, gg, pg) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    for n, g in gc.items():
        assert float((gg[n] - g).norm()) <= 5e-4 * float(g.norm()), n
    diff = torch.cat([(pg[n] - p).abs().flatten() for n, p in pc.items()])
    assert float((diff <= 1e-3 * cfg["lr"]).float().mean()) >= 0.999
    assert float(diff.max()) <= 0.5 * cfg["lr"]


@pytest.mark.cuda
def test_gather_windows_on_card_bit_equal_host(cuda_device):
    """The device window gather against the host gather it replaces."""
    import types

    from pfann_tpu_torch.data.segments import MusicSegmentDataset, gather_windows

    rng = np.random.default_rng(2)
    f = rng.integers(-32768, 32767, 200_000, dtype=np.int16)
    B, W_org, W_aug, shift = 64, 8000, 12000, 30000
    starts = rng.integers(-4000, f.shape[0] - 4000, size=(2, B))
    lo = np.minimum(starts[0], starts[1]) + rng.integers(0, 3000, B)
    hi = lo + rng.integers(4000, 20000, B)
    host = [MusicSegmentDataset._gather_host(types.SimpleNamespace(f=f), s, lo, hi, w)
            for s, w in ((starts[0], W_org), (starts[1], W_aug))]
    corpus = torch.from_numpy(np.pad(f, (shift, shift))).to(cuda_device)
    cues = [torch.from_numpy(a).to(cuda_device) for a in (starts[0], starts[1], lo, hi)]
    dev = gather_windows(corpus, *cues, w_org=W_org, w_aug=W_aug, shift=shift)
    for h, d in zip(host, dev):
        assert d.dtype == torch.int16
        np.testing.assert_array_equal(d.cpu().numpy(), h)


@pytest.mark.cuda
def test_augment_on_card_matches_cpu(cuda_device):
    """Noise, room IR, mic IR and log-mel on the card against the CPU with
    fixed draws: log-mel within 2e-3 (cuFFT and the CPU FFT round
    differently; the log-mel tolerance of the port's model tests)."""
    from pfann_tpu_torch.ops.augment import Augment
    from pfann_tpu_torch.ops.melspec import build_mel_spec_layer

    rng = np.random.default_rng(3)
    B, seg, pad, n_fft = 64, 8000, 4000, 32768
    x_org = rng.integers(-20000, 20000, (B, seg), dtype=np.int16)
    x_aug = rng.integers(-20000, 20000, (B, pad + seg), dtype=np.int16)
    noise = (rng.standard_normal(100_000) * 0.3).astype(np.float32)
    irs = np.zeros((5, 8000), np.float32)
    irs[:, 0] = 1.0
    irs[np.arange(5), rng.integers(1, 8000, 5)] = 0.4
    spectra = np.fft.rfft(irs, n_fft).astype(np.complex64)
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        aug = Augment(build_mel_spec_layer(TINY_MODEL).to(dev),
                      torch.from_numpy(noise).to(dev), torch.from_numpy(spectra[:3]).to(dev),
                      torch.from_numpy(spectra[3:]).to(dev), fftconv_n=n_fft, pad_start=pad,
                      segment_size=seg, snr_min=0.0, snr_max=10.0)
        draws = aug.draw(torch.Generator().manual_seed(7), B)
        out[dev.type] = aug(torch.from_numpy(x_org).to(dev), torch.from_numpy(x_aug).to(dev),
                            draws).cpu()
    assert out["cuda"].shape == (B, 2, 256, 32)
    np.testing.assert_allclose(out["cuda"].numpy(), out["cpu"].numpy(), rtol=0, atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["align", "screen"])
def test_traced_query_puts_every_kernel_under_a_span(cuda_device, tmp_path, engine):
    """One traced ``query_top1_batch`` an engine: every kernel and copy of
    the window was launched inside a program span (fpbench's reading of
    the profiler), the kernel inside the scan or the screen's stage 3, the
    records start within 50 us of their profiler ranges at the median, and
    the answers are the untraced ones."""
    from fpbench import program_trace
    from pfann_tpu_torch.utils import profiling

    rng = np.random.default_rng(15)
    emb, counts = _corpus(rng, 40, 32)
    root = str(tmp_path)
    emb.tofile(os.path.join(root, "embeddings"))
    counts.astype(np.int32).tofile(os.path.join(root, "landmarkKey"))
    with open(os.path.join(root, "songList.txt"), "w") as f:
        f.writelines("s%d.wav\n" % i for i in range(len(counts)))
    write_index_meta(root, d=32)
    params = {"top_k": 5, "screen": engine == "screen", "screen_top_m": 2}
    db = Database(root, params, 0.5, cuda_device)
    q, _ = _crops(rng, emb, counts, 8, 12)
    noise = rng.standard_normal((12, 32)).astype(np.float32)
    queries = list(q) + [noise / np.linalg.norm(noise, axis=1, keepdims=True)]
    want = db.query_top1_batch(queries)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    profiling.enable()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("window"):
                got = db.query_top1_batch(queries)
                torch.cuda.synchronize()
    finally:
        profiling.disable()
    assert got == want
    pt = program_trace.read(prof, profiling.records())
    assert pt.device_by_span and program_trace.UNATTRIBUTED not in pt.device_by_span
    if engine == "screen":
        assert "align_reduce" in " ".join(pt.kernels_by_span["screen.stage3"])
    else:
        assert "align_reduce" in " ".join(pt.kernels_by_span["align.scan"])
    median_us, _ = program_trace.clock_gap_us(pt)
    assert median_us <= 50.0


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["align", "screen"])
def test_trimmed_top1_on_card(cuda_device, tmp_path, monkeypatch, engine):
    """One ``query_top1_batch`` an engine at d = 64 with 19-row queries, 51
    of them noise that the screen escalates: every launch takes the
    queries' 19 windows (stage 1 its 5 collapsed rows), not the bucketed 24
    (6), and the answers equal the bucketed launches' (S*d 1,216 and 1,536
    both sum in one chain); the screen's stage 3 keeps its query tile
    resident."""
    rng = np.random.default_rng(19)
    counts = rng.integers(60, 121, size=300)
    counts[0] = 120  # R = 152 exhaustive, 160 screened, as in the benchmark
    emb = _corpus_rows(rng, counts, 64)
    root = str(tmp_path)
    emb.tofile(os.path.join(root, "embeddings"))
    counts.astype(np.int32).tofile(os.path.join(root, "landmarkKey"))
    with open(os.path.join(root, "songList.txt"), "w") as f:
        f.writelines("s%d.wav\n" % i for i in range(len(counts)))
    write_index_meta(root, d=64)
    db = Database(root, {"top_k": 5, "screen": engine == "screen", "screen_top_m": 8}, 0.5,
                  cuda_device)
    q, src = _crops(rng, emb, counts, 200, 19)
    noise = rng.standard_normal((51, 19, 64)).astype(np.float32)
    queries = list(q) + list(noise / np.linalg.norm(noise, axis=2, keepdims=True))
    plans = []
    real = align_kernel.tile_plan

    def recorded(*a):
        plans.append((a, real(*a)))
        return plans[-1][1]

    monkeypatch.setattr(align_kernel, "tile_plan", recorded)
    got = db.query_top1_batch(queries)
    trimmed = plans[:]
    filters = Database._filters
    monkeypatch.setattr(db, "_filters", lambda qs, bucket=True: filters(db, qs))
    want = db.query_top1_batch(queries)
    bucketed = plans[len(trimmed):]
    assert got == want
    assert [song for _, (song, _) in got[:200]] == list(src)
    assert db.window_rows_trimmed == 5 * len(queries)
    if engine == "align":
        assert [a[:2] for a, _ in trimmed] == [(251, 19)]
        assert [a[:2] for a, _ in bucketed] == [(251, 24)]
        return
    assert db._align.escalated == 2 * 51
    assert [a[:2] for a, _ in trimmed] == [(251, 5), (51, 19)]
    assert [a[:2] for a, _ in bucketed] == [(251, 6), (51, 24)]
    stage3 = trimmed[1][1]
    assert stage3["resident"] and stage3["qs"] == 19 and not stage3["rowsum"]
    assert not bucketed[1][1]["resident"]


@pytest.mark.cuda
def test_kernel_at_stage3_trimmed_shape_on_card(cuda_device):
    """The kernel at the benchmark's stage-3 shape, B = 51, S = 19, d = 64,
    R = 160 (the screened layout of 120-row songs), its query tile
    resident: best within BEST_ATOL of the plain version's on the CPU, and
    the score at each offset the kernel picks within BEST_ATOL of it."""
    rng = np.random.default_rng(51)
    counts = rng.integers(60, 121, size=300)
    counts[0] = 120
    db3, _, R, _, n_pad = build_screen_layout(_corpus_rows(rng, counts, 64), counts, pad=32,
                                              k=4, d=64)
    B, S, d = 51, 19, 64
    assert R == 160 and align_kernel.tile_plan(B, S, d, 2, R, n_pad)["resident"]
    qs = rng.standard_normal((B, S, d)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=2, keepdims=True)
    dbt = torch.from_numpy(db3.reshape(-1, d)).to(cuda_device, torch.bfloat16)
    qt = torch.from_numpy(qs).to(cuda_device, torch.bfloat16)
    before = align_reduce.launches
    kb, ko = (x.cpu().numpy() for x in align_reduce(dbt, qt, R, S, n_pad))
    assert align_reduce.launches == before + 1
    pb, _ = (x.numpy() for x in align_reduce_reference(dbt.cpu(), qt.cpu(), R, S, n_pad))
    np.testing.assert_allclose(kb, pb, rtol=0, atol=BEST_ATOL)
    rows = np.concatenate([dbt.float().cpu().numpy(), np.zeros((S, d), np.float32)])
    idx = (np.arange(n_pad) * R)[None, :, None] + ko[:, :, None] + np.arange(S)
    at = np.einsum("bnsd,bsd->bn", rows[idx], qt.float().cpu().numpy())
    np.testing.assert_allclose(at, pb, rtol=0, atol=BEST_ATOL)


# ------------------------------------------------------------------ norm_act
# FpNetwork's norm and activation as one kernel (models/norm_act.py), held to
# its plain version (F.layer_norm of the f32 copy, the cast back, the
# activation) run on the card.  bf16 outputs within one bf16 ulp of the
# plain one (of the norm's value where ELU follows it), or within NORM_ATOL
# near 0 (the two sum the statistics in other
# orders, ~1e-6 of the volume's scale, which can move a value of a few
# hundredths' worth by more than its ulp); f32 outputs within NORM_F32 of
# the output's scale; the kernel's f32 mean within 1e-6 of the volume's scale
# (sqrt(mean^2 + var)) and its rstd within 1e-6 relative, both of float64
# statistics of the same input.
NORM_ENCODERS = {
    "d128": {"d": 128, "h": 1024, "u": 32, "fuller": True},
    "n640d64": {"d": 64, "h": 1024, "u": 32, "fuller": False},
}
NORM_ATOL = 1e-5
NORM_F32 = 1e-5
STATS_RTOL = 1e-6


def _norm_cfg(encoder, **model):
    return dict(TINY_MODEL, model=dict(NORM_ENCODERS[encoder], **model))


def _norm_shapes(encoder):
    blocks = build_fp_network(_norm_cfg(encoder)).f.blocks
    return [ln.shape for b in blocks for ln in (b.ln1, b.ln2)]


def _bf16_ulp(t):
    return torch.exp2(torch.floor(torch.log2(t.abs().clamp_min(2.0 ** -126))) - 7)


def _norm_close(got, want, scale, elu_after=False, chunk=256):
    """bf16: within one ulp of ``want`` or NORM_ATOL; where ELU follows the
    rounded norm, the ulp is the norm's (elu's input, log1p of a negative
    output) plus the output's own: the two may round the norm to
    neighbours, which ELU takes to outputs up to that far apart; f32: within
    NORM_F32 * scale; in chunks of segments (the largest tensors are 5 GB)."""
    for i in range(0, got.shape[0], chunk):
        g, w = got[i : i + chunk].float(), want[i : i + chunk].float()
        if got.dtype == torch.bfloat16:
            tol = _bf16_ulp(w)
            if elu_after:
                tol = tol + _bf16_ulp(torch.where(w < 0, torch.log1p(w.clamp_min(-0.999)), w))
            tol = tol.clamp_min(NORM_ATOL)
        else:
            tol = NORM_F32 * scale
        bad = ((g - w).abs() > tol) & ~(g.isnan() & w.isnan())
        assert not bool(bad.any()), (i, float((g - w).abs().max()), int(bad.sum()))


def _stats64(x, eps, activation, relu_after_bn, chunk=256):
    """float64 (mean, rstd, scale) of each segment of x (of act(x), rounded
    to x's dtype, where the activation comes first)."""
    out = []
    for i in range(0, x.shape[0], chunk):
        a = x[i : i + chunk]
        if not relu_after_bn:
            a = na.ACTIVATIONS[activation](a)
        a = a.reshape(a.shape[0], -1).double()
        mean, var = a.mean(1), a.var(1, unbiased=False)
        out.append(torch.stack([mean, (var + eps).rsqrt(), (mean.square() + var).sqrt()], 1))
    return torch.cat(out)


def _check_norm(x, w, b, activation, relu_after_bn, p=None):
    """The kernel (the plan's, or ``p``) against the plain version and
    float64 statistics; returns the kernel's output."""
    want = na.norm_act_reference(x, w, b, 1e-5, activation, relu_after_bn)
    got = x.clone()
    stats = torch.empty(x.shape[0], 2, device=x.device)
    plan = p or na.plan(x[0].numel(), x.element_size())
    na._launch(got, w, b, 1e-5, activation, relu_after_bn, plan, stats)
    scale = float(w.abs().max() * 6 + b.abs().max())
    _norm_close(got, want, scale, elu_after=activation == "ELU" and relu_after_bn)
    ref = _stats64(x, 1e-5, activation, relu_after_bn)
    st = stats.double()
    mean_err = ((st[:, 0] - ref[:, 0]).abs() / ref[:, 2].clamp_min(1e-30)).max()
    rstd_err = ((st[:, 1] - ref[:, 1]).abs() / ref[:, 1]).max()
    assert mean_err <= STATS_RTOL and rstd_err <= STATS_RTOL, (plan, mean_err, rstd_err)
    return got


def _affine(shape, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (1 + 0.2 * torch.randn(shape, generator=g, device=dev),
            0.1 * torch.randn(shape, generator=g, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 4864])
@pytest.mark.parametrize("encoder", list(NORM_ENCODERS))
def test_norm_act_kernel_against_plain(cuda_device, encoder, n):
    """All 16 norm volumes of the encoder, ReLU and ELU, the activation
    after and before the norm, bf16 (and f32 for n < 4,864) at n segments:
    the plan's kernel against the plain version on the card; norm_act
    counts one launch a call and equals the checked output."""
    g = torch.Generator(device=cuda_device).manual_seed(n)
    for i, shape in enumerate(_norm_shapes(encoder)):
        w, b = _affine(shape, cuda_device, i)
        for dtype in (torch.bfloat16,) + ((torch.float32,) if n < 4864 else ()):
            x = (torch.randn((n, *shape), generator=g, device=cuda_device, dtype=dtype) * 1.7
                 + 0.3)
            for activation in ("ReLU", "ELU"):
                for relu_after_bn in (True, False):
                    got = _check_norm(x, w, b, activation, relu_after_bn)
                    before = na.launches
                    y = x.clone()
                    assert na.norm_act(y, w, b, 1e-5, activation, relu_after_bn) is y
                    assert na.launches == before + 1
                    assert torch.equal(y, got)
            del x, got, y


@pytest.mark.cuda
def test_norm_act_every_form_on_card(cuda_device):
    """Every form and tile the source builds gives the plain version's
    output, in bf16 and f32 at 37 segments (whole and partial groups of a
    tile's segments and of the split form's 16 an apply block): each rows
    tile whose block holds the segment, and the split form.  A segment that
    is not whole 16-byte vectors, or an unaligned view, is refused before
    any launch."""
    for shape in ((128, 256, 16), (256, 32, 4), (256, 32, 2), (256, 16, 2)):
        w, b = _affine(shape, cuda_device, 0)
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((37, *shape), device=cuda_device, dtype=dtype)
            nv = x[0].numel() * x.element_size() // 16
            plans = [dict(form="rows", vpt=vpt, G=max(32, na._pow2(-(-nv // vpt))), segs=segs)
                     for vpt, segs in na.ROWS_TILES if nv <= na.THREADS * vpt]
            for p in plans + [dict(form="split")]:
                for activation, relu_after_bn in (("ReLU", True), ("ELU", False)):
                    _check_norm(x, w, b, activation, relu_after_bn, p)
    before = na.launches
    for shape in ((3, 5, 7), (33, 65, 17), (1, 1, 1)):
        w, b = _affine(shape, cuda_device, 1)
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((9, *shape), device=cuda_device, dtype=dtype)
            with pytest.raises(ValueError, match="16-byte"):
                na.norm_act(x, w, b, 1e-5, "ReLU", True)
    shape = (16, 8, 8)
    w, b = _affine(shape, cuda_device, 2)
    buf = torch.randn(5 * 1024 + 1, device=cuda_device, dtype=torch.bfloat16)
    x = buf[1:].view(5, *shape)  # 2 bytes off 16-byte alignment
    with pytest.raises(ValueError, match="16-byte aligned"):
        na.norm_act(x, w, b, 1e-5, "ReLU", True)
    assert na.launches == before


@pytest.mark.cuda
def test_norm_act_past_2_32_elements_on_card(cuda_device):
    """Block 0's ln1 volume at 8,228 segments (4.3e9 elements, past 2^32):
    the kernel in one call against the plain version in calls of 1,024
    segments."""
    shape, n = (128, 256, 16), 8228
    w, b = _affine(shape, cuda_device, 3)
    x = torch.randn((n, *shape), device=cuda_device, dtype=torch.bfloat16)
    got = na.norm_act(x.clone(), w, b, 1e-5, "ReLU", True)
    for i in range(0, n, 1024):
        want = na.norm_act_reference(x[i : i + 1024], w, b, 1e-5, "ReLU", True)
        _norm_close(got[i : i + 1024], want, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("encoder", list(NORM_ENCODERS))
def test_norm_act_fp_network_on_card(cuda_device, encoder):
    """FpNetwork in bf16 on the card: under inference_mode every norm is a
    kernel launch (16); with autograd none is; the embeddings agree to a
    cosine of 0.9999 per row."""
    torch.manual_seed(0)
    model = build_fp_network(_norm_cfg(encoder), compute_dtype=torch.bfloat16).to(cuda_device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".ln" in name:
                p.copy_((1.0 if name.endswith("weight") else 0.0) + 0.1 * torch.randn_like(p))
    mel = torch.randn(64, 256, 32, device=cuda_device) * 2 - 4
    before = na.launches
    with torch.inference_mode():
        zk = model(mel)
    assert na.launches == before + 16
    zt = model(mel.clone().requires_grad_(True)).detach()
    assert na.launches == before + 16
    cos = torch.nn.functional.cosine_similarity(zk, zt, dim=1)
    assert float(cos.min()) >= 0.9999, cos.min()


@pytest.mark.cuda
def test_norm_act_paths_on_card(cuda_device, tmp_path):
    """The Trainer's step and embed_with_saliency launch no norm_act
    kernel on the card; Embedder.embed and the Trainer's validation
    embedding launch 16 a call."""
    from pfann_tpu_torch.train.trainer import Trainer

    tr = Trainer(dict(TRAIN_CFG, optimizer="adam"), compute_dtype=torch.bfloat16,
                 device=cuda_device)
    tr.init_state()
    x = torch.randn(16, 256, 32, device=cuda_device)
    before = na.launches
    tr.train_step(x, tr.specaug.draw(torch.Generator().manual_seed(0), 256, 32))
    assert na.launches == before
    tr._embed_all([x])
    assert na.launches == before + 16
    path = str(tmp_path / "model.msgpack")
    save_model(path, build_fp_network(TINY_MODEL).state_dict())
    emb = Embedder(TINY_MODEL, path, cuda_device, chunk=8)
    segs = np.random.default_rng(6).standard_normal((5, 8000)).astype(np.float32) * 0.1
    emb.embed_with_saliency(segs)
    assert na.launches == before + 16
    emb.embed(segs)
    assert na.launches == before + 32
