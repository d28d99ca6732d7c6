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
the runner-up offset is more than that below the best; BEST_ATOL = 2e-3
(chip_smoke.py's) where the queries are not unit-scaled per element.
int8 is bitwise equal everywhere.
"""

import itertools

import numpy as np
import pytest
import torch

from pfann_tpu_torch.index import align_kernel
from pfann_tpu_torch.index.align import build_uniform_layout
from pfann_tpu_torch.index.align_kernel import (
    BOX_MAX,
    CHAIN_MAX_SD,
    F32_TILE,
    INT8_MAX_SD,
    QUERY_RING,
    QUERY_TILES,
    SMEM_LIMIT,
    TILE_CONFIGS,
    WGMMA_BUILT,
    align_reduce,
    align_reduce_reference,
    copy_bytes,
    padded_width,
    reduce_per_song,
    row_stride,
    smem_bytes,
    tile_plan,
    wgmma_smem_bytes,
)

BEST_ATOL = 2e-3


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


# ------------------------------------------------------------ the tile plan
def _pr2_smem(d, S, itemsize):
    """Shared memory of the CUDA-core kernel that bf16 and int8 ran on
    before the tensor-core kernel: 64 offsets + S - 1 rows and 64 query
    rows of 4-byte units (f32, or four int8), row stride rounded up to 4
    units plus 4."""
    du = d // 4 if itemsize == 1 else d
    return max((64 + S - 1 + 64) * ((du + 3) // 4 * 4 + 4) * 4, 16 * 64 * 8)


def _smem_limit(plan):
    """Shared memory a block of the plan may take: all a block may use at
    one block an SM, half the SM less its 1 KB at two."""
    return min(SMEM_LIMIT, align_kernel.SM_SMEM // plan["bps"] - 1024)


@pytest.mark.parametrize("itemsize", [2, 1])
@pytest.mark.parametrize("d", [4, 12, 64, 128])
@pytest.mark.parametrize("S", [1, 5, 19, 32, 119])
@pytest.mark.parametrize("B", [1, 7, 32, 100, 1024])
def test_tile_plan(B, S, d, itemsize):
    """The wgmma plan: its query tile is the smallest of the dtype's tiles
    that holds B, row sums past S*d = CHAIN_MAX_SD, an instantiation of
    TILE_CONFIGS with its subtile rows and threads, a ring of A stages and
    query stages (the tile resident only where the ring holds its S rows),
    TMA boxes of at most 256 rows covering an A stage, shared memory as
    the source counts it and within the block's share, a persistent grid
    of at most one block an item and SMS * bps blocks, and work items that
    cover every (song, query) exactly once."""
    R, n_songs = S + 41, 1009  # R not a multiple of any TM, n_songs prime
    plan = tile_plan(B, S, d, itemsize, R, n_songs)
    tn, G, sc = plan["tn"], plan["G"], plan["sc"]
    configs = TILE_CONFIGS[(itemsize, itemsize == 2 and S * d > CHAIN_MAX_SD)]
    tiles = sorted({t for *_, ts in configs for t in ts})
    assert tn == min(t for t in tiles if t >= min(B, tiles[-1]))
    assert plan["rowsum"] == (itemsize == 2 and S * d > CHAIN_MAX_SD)
    cfg = (plan["rowsum"], plan["nwg"], plan["mt"], plan["pp"], plan["bps"])
    assert any(c[:5] == cfg and tn in c[5] for c in configs)
    assert (itemsize, *cfg, tn) in WGMMA_BUILT
    assert plan["tm"] == 64 * plan["mt"] * plan["nwg"]
    assert plan["threads"] == 128 * (plan["nwg"] + 1)
    assert 1 <= sc <= S and plan["abuf"] in (1, 2)
    assert plan["sc"] == S or plan["abuf"] == 1  # window-row chunks restage A
    assert plan["qs"] == S if plan["resident"] else plan["qs"] in (2, QUERY_RING)
    assert plan["box_rows"] <= BOX_MAX and plan["box_rows"] % 8 == 0
    assert plan["n_box"] * plan["box_rows"] >= plan["tm"] + sc - 1
    assert (plan["n_box"] - 1) * plan["box_rows"] < plan["tm"] + sc - 1
    assert plan["smem"] == wgmma_smem_bytes(d, itemsize, plan["tm"], tn, G, sc, plan["abuf"],
                                            plan["qs"])
    assert plan["smem"] <= _smem_limit(plan)
    gx, gy = plan["grid"]
    assert plan["blocks"] == min(gx * gy, align_kernel.SMS * plan["bps"])
    seen = np.zeros((B, n_songs), np.int32)
    for x, y in itertools.product(range(gx), range(gy)):
        seen[y * tn : (y + 1) * tn, x * G : (x + 1) * G] += 1
    assert (seen == 1).all()


def test_tile_plan_groups_songs():
    """At the serving shapes a work item owns several songs, and the rows
    it rounds up to whole subtiles are few; bf16 at 1,024 and 256 queries
    takes 128-query tiles streaming through a ring of QUERY_RING, int8
    stage 1 keeps its 64-query tile resident at three blocks an SM."""
    for B, S, itemsize, R, n_songs in ((1024, 19, 2, 152, 10_000), (32, 19, 2, 152, 10_000),
                                       (256, 19, 2, 160, 100_000), (1024, 5, 1, 40, 100_000)):
        plan = tile_plan(B, S, 128, itemsize, R, n_songs)
        rows = plan["G"] * R
        waste = (-(-rows // plan["tm"]) * plan["tm"] - rows) / rows
        assert plan["G"] > 1 and waste < 0.05, plan
        assert plan["abuf"] == 2 and plan["sc"] == S
    for B, R, n_songs in ((1024, 152, 10_000), (256, 160, 100_000)):
        plan = tile_plan(B, 19, 128, 2, R, n_songs)
        assert (plan["tn"], plan["tm"], plan["qs"], plan["resident"]) == (128, 128, QUERY_RING,
                                                                           False)
    plan = tile_plan(32, 19, 128, 2, 152, 10_000)
    assert (plan["tn"], plan["tm"]) == (32, 256)  # 256 rows a staged query row
    plan = tile_plan(1024, 5, 128, 1, 40, 100_000)
    assert (plan["tn"], plan["tm"], plan["bps"], plan["resident"], plan["qs"]) == (
        64, 64, 3, True, 5)
    assert 3 * (plan["smem"] + 1024) <= align_kernel.SM_SMEM
    assert plan["blocks"] == 3 * align_kernel.SMS


def test_tile_plan_takes_every_pr2_shape():
    """Every (d, S) the CUDA-core kernel fitted in shared memory has a
    tensor-core plan, and S beyond it is split into window-row chunks."""
    for itemsize in (2, 1):
        for d in range(4, 2049, 4):
            for S in (1, 2, 3, 19, 33, 119, 128, 300, 1000, 5000):
                if itemsize == 1 and S * d > INT8_MAX_SD:
                    continue
                if _pr2_smem(d, S, itemsize) <= SMEM_LIMIT or d <= 256:
                    plan = tile_plan(7, S, d, itemsize, 150, 50)
                    assert plan["smem"] <= _smem_limit(plan)


@pytest.mark.parametrize("itemsize", [2, 1])
@pytest.mark.parametrize("d", [4, 8, 12, 16, 20, 64, 124, 128])
def test_tma_padding(d, itemsize):
    """TMA reads rows of a multiple of 16 bytes from 16-byte aligned bases:
    d is padded with zero columns to the least such width, which leaves
    every sum unchanged; aligned rows and bases are passed as they are,
    and a view off 16-byte alignment becomes an aligned copy."""
    dp = padded_width(d, itemsize)
    assert dp * itemsize % 16 == 0 and d <= dp < d + 16 // itemsize
    assert (dp == d) == (d * itemsize % 16 == 0)
    rng = np.random.default_rng(d)
    dtype = torch.int8 if itemsize == 1 else torch.bfloat16
    db = torch.from_numpy(rng.integers(-9, 10, (50, d)).astype(np.float32)).to(dtype)
    q = torch.from_numpy(rng.integers(-9, 10, (3, 4, d)).astype(np.float32)).to(dtype)
    pdb, pq = align_kernel._tma_aligned(db, q)
    assert pdb.shape == (50, dp) and pq.shape == (3, 4, dp)
    assert torch.equal(pdb[:, :d], db) and not pdb[:, d:].any() and not pq[..., d:].any()
    if dp == d:
        assert pdb.data_ptr() == db.data_ptr() and pq.data_ptr() == q.data_ptr()
    for got, want in zip(align_reduce(pdb, pq, 10, 4, 5), align_reduce(db, q, 10, 4, 5)):
        assert torch.equal(got, want)
    if dp == d:  # a view 4 bytes into its storage: off 16-byte alignment
        flat = torch.zeros(50 * d + 4 // itemsize, dtype=dtype)
        view = flat[4 // itemsize:].view(50, d)
        if view.data_ptr() % 16:
            moved, _ = align_kernel._tma_aligned(view, q)
            assert moved.data_ptr() % 16 == 0 and torch.equal(moved, view)


def _order_key(x):
    """The kernel's order-preserving 32-bit key of an f32 sum (float_order
    in the source): -0.0 ranks as +0.0."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = np.where((u << 1) & 0xFFFFFFFF == 0, 0, u)
    return np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_epilogue_merge_rule(seed, ties):
    """The per-song tables of the kernel's epilogue: each warp's slice of
    each subtile folds into (value, offset) tables by two passes (the max
    key, then the largest offset reaching it), slices in any order within
    a subtile and subtiles in order, as the kernel's barriers allow.  "The
    larger value, then the larger offset" is commutative and associative,
    so any order gives reduce_per_song's answer, with ties (and -0.0
    against +0.0) to the later offset."""
    rng = np.random.default_rng(seed)
    n_songs, R, n = 7, 40, 5
    if ties:  # few distinct values: many exact ties, zeros of both signs
        align = rng.choice(np.float32([-0.0, 0.0, 1.0, -2.5, 3.0]), (n_songs * R, n))
    else:
        align = rng.standard_normal((n_songs * R, n)).astype(np.float32)
    want_best, want_off = reduce_per_song(torch.from_numpy(align), n_songs, R)
    tm, wm = 64, 16  # rows a subtile, rows a warp slice
    vals = np.zeros((n_songs, n), np.uint64)
    offs = np.zeros((n_songs, n), np.int64)
    song, off = np.arange(n_songs * R) // R, np.arange(n_songs * R) % R
    keys = _order_key(align)
    for t0 in range(0, n_songs * R, tm):
        slices = [np.arange(w, min(w + wm, n_songs * R)) for w in range(t0, t0 + tm, wm)]
        slices = [s for s in slices if len(s)]
        for i in rng.permutation(len(slices)):  # pass 1, any order
            for r in slices[i]:
                vals[song[r]] = np.maximum(vals[song[r]], keys[r])
        for i in rng.permutation(len(slices)):  # pass 2, any order
            for r in slices[i]:
                hit = keys[r] == vals[song[r]]
                offs[song[r]] = np.where(hit, np.maximum(offs[song[r]], off[r]),
                                         offs[song[r]])
    np.testing.assert_array_equal(_order_key(want_best.T.numpy()), vals)
    np.testing.assert_array_equal(want_off.T.numpy(), offs)


def _covered_once(plan, B, n_songs):
    """The plan's grid covers every query and every song exactly once."""
    gx, gy = plan["grid"]
    songs, queries = np.zeros(n_songs, np.int32), np.zeros(B, np.int32)
    for x in range(gx):
        songs[x * plan["G"] : (x + 1) * plan["G"]] += 1
    for y in range(gy):
        queries[y * plan["tn"] : (y + 1) * plan["tn"]] += 1
    return (songs == 1).all() and (queries == 1).all()


@pytest.mark.parametrize("R", [40, 152, 160])
@pytest.mark.parametrize("d", [4, 12, 64, 128])
@pytest.mark.parametrize("S", [1, 5, 19, 32, 119])
@pytest.mark.parametrize("B", [1, 7, 32, 65, 1024])
def test_f32_tile_plan(B, S, d, R):
    """The f32 plan fits shared memory, its grid covers every (song,
    query) once, its query tile is the smallest tile that holds B, it
    takes two A stages where they fit, and it splits the window rows into
    chunks only where a whole window does not fit (S = 119 at d = 128 with
    64 queries a block)."""
    n_songs = 1009  # prime: no G divides it
    plan = tile_plan(B, S, d, 4, R, n_songs)
    tn, G, sc = plan["tn"], plan["G"], plan["sc"]
    assert plan["smem"] <= SMEM_LIMIT
    assert tn == min(t for t in QUERY_TILES if t >= min(B, QUERY_TILES[-1]))
    assert (plan["tm"], plan["threads"]) == F32_TILE
    assert not plan["rowsum"] and 1 <= sc <= S and plan["abuf"] in (1, 2)
    assert plan["smem"] == smem_bytes(d, 4, plan["tm"], tn, G, sc, plan["abuf"])
    assert row_stride(d, 4) == 4 * d + 16  # float4 rows, 16 bytes apart in banks
    whole = smem_bytes(d, 4, plan["tm"], tn, G, S, 2)
    assert plan["abuf"] == (2 if whole <= SMEM_LIMIT else 1)
    assert (sc < S) == (smem_bytes(d, 4, plan["tm"], tn, G, S, 1) > SMEM_LIMIT)
    if d == 128 and S == 119 and B >= 64:
        assert sc < S
    assert _covered_once(plan, B, n_songs)


def test_f32_tile_plan_serving_shapes():
    """At the f32 serving shapes a block owns whole songs, wastes under 2%
    of its rows rounding to subtiles, and takes 64 queries a block (32 at
    the matcher's batch)."""
    for B, S, R, n_songs, tn in ((1024, 19, 152, 10_000, 64), (32, 19, 152, 10_000, 32),
                                 (1024, 5, 40, 100_000, 64), (256, 19, 160, 100_000, 64)):
        plan = tile_plan(B, S, 128, 4, R, n_songs)
        rows = plan["G"] * R
        waste = (-(-rows // plan["tm"]) * plan["tm"] - rows) / rows
        assert plan["tn"] == tn and plan["G"] > 1 and waste < 0.02, plan
        assert plan["sc"] == S


def test_copy_bytes():
    assert copy_bytes(256, 0, 4096) == 16
    assert copy_bytes(24, 0, 4096) == 8
    assert copy_bytes(12, 0, 64) == 4
    assert copy_bytes(256, 2, 64) == 0  # a pointer off 4-byte alignment


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
    # a bf16 view one element off 4-byte alignment raises instead of copying
    flat = torch.zeros(40 * 8 + 1, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        align_reduce(flat[1:].view(40, 8),
                     torch.zeros(2, 3, 8, dtype=torch.bfloat16, device=cuda_device), 10, 3, 2)


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


def _card_case(rng, dtype, B, S, d, n_songs):
    """A layout of n_songs songs at pad >= S (R not a multiple of any TM)
    and queries [B, S, d]: unit rows and queries scaled by 1/sqrt(d) in
    f32/bf16, +-127-scale integers in int8."""
    pad = next(p for p in (8, 32, 128) if p >= S)
    counts = rng.integers(2, 3 * S + 30, size=n_songs)
    if dtype == torch.int8:
        db, R = build_uniform_layout(
            rng.integers(-127, 128, size=(int(counts.sum()), d)).astype(np.float32),
            counts, pad=pad)
        qs = rng.integers(-127, 128, size=(B, S, d)).astype(np.float32)
        return db.astype(np.int8), qs.astype(np.int8), R
    db, R = build_uniform_layout(_corpus(rng, counts, d), counts, pad=pad)
    qs = (rng.standard_normal((B, S, d)) / np.sqrt(d)).astype(np.float32)
    return db, qs, R


def _hold_to_plain(dbt, qt, R, S, n_songs):
    """Kernel vs plain version on the card: int8 bitwise; f32 and bf16
    best within BEST_ATOL and argoff equal where the margin is clear."""
    before = align_reduce.launches
    kb, ko = align_reduce(dbt, qt, R, S, n_songs)
    torch.cuda.synchronize()
    assert align_reduce.launches == before + 1
    pb, po = align_reduce_reference(dbt, qt, R, S, n_songs)
    if dbt.dtype == torch.int8:
        assert torch.equal(kb, pb) and torch.equal(ko, po)
        return kb, ko
    np.testing.assert_allclose(kb.cpu().numpy(), pb.cpu().numpy(), rtol=0, atol=BEST_ATOL)
    want = _definition(dbt.float().cpu().numpy(), qt.float().cpu().numpy(), R, S, n_songs)
    top2 = np.sort(want, axis=2)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > BEST_ATOL
    np.testing.assert_array_equal(ko.cpu().numpy()[clear], po.cpu().numpy()[clear])
    return kb, ko


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float32])
@pytest.mark.parametrize("d", [4, 12, 64, 128])
@pytest.mark.parametrize("S", [1, 2, 19, 32, 119])
@pytest.mark.parametrize("B", [1, 7, 8, 9, 33, 65, 1024])
def test_kernel_shapes_on_card(cuda_device, monkeypatch, B, S, d, dtype):
    """Every query tile and its edges, S up to the pad, d down to 4 (K
    zero-filled to the MMA depth), n_songs not a multiple of G (one SM
    assumed, so that blocks group several of these few songs)."""
    monkeypatch.setattr(align_kernel, "SMS", 1)
    rng = np.random.default_rng(B * 1000 + S * 10 + d)
    n_songs = 23
    db, qs, R = _card_case(rng, dtype, B, S, d, n_songs)
    _hold_to_plain(torch.from_numpy(db).to(cuda_device, dtype),
                   torch.from_numpy(qs).to(cuda_device, dtype), R, S, n_songs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float32])
@pytest.mark.parametrize("B", [1, 32, 256, 1024])
def test_kernel_short_k_on_card(cuda_device, monkeypatch, dtype, B):
    """The screened engine's stage-1 shape: regions of R = 40 rows, S = 5
    (K = 640 at d = 128, an epilogue every few K-steps), many songs a
    block (one SM assumed), n_songs not a multiple of G and no trailing
    zero rows."""
    monkeypatch.setattr(align_kernel, "SMS", 1)
    rng = np.random.default_rng(B + 5)
    S, d, R, n_songs = 5, 128, 40, 397
    db = rng.standard_normal((n_songs * R, d)).astype(np.float32)
    qs = rng.standard_normal((B, S, d)).astype(np.float32)
    if dtype == torch.int8:
        db, qs = (np.clip(np.rint(x * 40), -127, 127).astype(np.int8) for x in (db, qs))
    else:
        db /= np.linalg.norm(db, axis=1, keepdims=True)
        qs /= np.sqrt(d)
    plan = tile_plan(B, S, d, torch.empty((), dtype=dtype).element_size(), R, n_songs)
    assert n_songs % plan["G"]
    _hold_to_plain(torch.from_numpy(db).to(cuda_device, dtype),
                   torch.from_numpy(qs).to(cuda_device, dtype), R, S, n_songs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float32])
@pytest.mark.parametrize("B", [1, 32, 1024])
def test_kernel_ties_on_card(cuda_device, monkeypatch, dtype, B):
    """Exact ties go to the later offset: one window planted twice in song
    0, at offsets 100 and 280 (R = 300: another M-subtile at TM = 64, 128
    and 256), and once in song 1 at offset 10, in the same block as song 0.
    All sums are exact (small integers, scaled by 1/8 for bf16); in int8
    they pass 2^24."""
    monkeypatch.setattr(align_kernel, "SMS", 1)
    rng = np.random.default_rng(B)
    S, d, R, n_songs = 19, 128, 300, 7
    hi, scale = (127, 1) if dtype == torch.int8 else (8, 8)
    db = (rng.integers(-hi, hi + 1, size=(n_songs * R, d)) / scale).astype(np.float32)
    win = np.where(rng.random((S, d)) < 0.5, -hi, hi) / scale
    qs = (rng.integers(-hi, hi + 1, size=(B, S, d)) / scale).astype(np.float32)
    qs[0] = win
    for row in (100, 280, R + 10):
        db[row : row + S] = win
    plan = tile_plan(B, S, d, torch.empty((), dtype=dtype).element_size(), R, n_songs)
    if B > 1:
        assert plan["G"] >= 2  # songs 0 and 1 share a block
    npd = np.int8 if dtype == torch.int8 else np.float32
    kb, ko = _hold_to_plain(torch.from_numpy(db.astype(npd)).to(cuda_device, dtype),
                            torch.from_numpy(qs.astype(npd)).to(cuda_device, dtype),
                            R, S, n_songs)
    top = float((win.astype(np.float64) ** 2).sum())
    assert kb[0, 0].item() == top and kb[0, 1].item() == np.float32(top)
    assert ko[0, 0].item() == 280 and ko[0, 1].item() == 10
    if dtype == torch.int8:
        assert top > 2**24


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float32])
def test_kernel_zero_regions_on_card(cuda_device, dtype):
    """A region of zero rows scores 0 at every offset (+0.0 or -0.0 from
    negative query entries): best is 0 and argoff R - 1, the last offset."""
    rng = np.random.default_rng(3)
    S, d, n_songs, B = 19, 128, 11, 40
    db, qs, R = _card_case(rng, dtype, B, S, d, n_songs)
    db[3 * R : 6 * R + S] = 0  # songs 3-5 and the window rows past them
    kb, ko = _hold_to_plain(torch.from_numpy(db).to(cuda_device, dtype),
                            torch.from_numpy(qs).to(cuda_device, dtype), R, S, n_songs)
    assert (kb[:, 3:6] == 0).all()
    assert (ko[:, 3:6] == R - 1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("pad,S", [(32, 19), (32, 24), (32, 32), (128, 119)])
@pytest.mark.parametrize("B", [1, 8, 32, 100, 1024])
def test_wgmma_phase3_shapes_on_card(cuda_device, monkeypatch, dtype, pad, S, B):
    """The wgmma route at chip_smoke.py phase 3's shapes: pad 32 and 128, S
    in {19, 24, 32, 119} (bf16; 119 sums each window row apart), int8 at
    the screened engine's Sc = ceil(S / 4) in {5, 6, 8, 30} (bitwise), with
    a song count that leaves the last work item's song group and its last
    subtile ragged (one SM assumed, so that items group several songs)."""
    monkeypatch.setattr(align_kernel, "SMS", 1)
    rng = np.random.default_rng(S * B + pad)
    d, n_songs = 128, 211
    counts = rng.integers(40, 101 if dtype == torch.int8 else 118, size=n_songs)
    if dtype == torch.int8:
        S = -(-S // 4)
        db, R = build_uniform_layout(
            rng.integers(-127, 128, size=(int(counts.sum()), d)).astype(np.float32),
            counts, pad=pad // 4)
        qs = rng.integers(-127, 128, size=(B, S, d)).astype(np.int8)
        db = db.astype(np.int8)
    else:
        db, R = build_uniform_layout(_corpus(rng, counts, d), counts, pad=pad)
        qs = (rng.standard_normal((B, S, d)) / np.sqrt(d)).astype(np.float32)
    plan = tile_plan(B, S, d, torch.empty((), dtype=dtype).element_size(), R, n_songs)
    assert n_songs % plan["G"] and (plan["G"] * R) % plan["tm"]
    _hold_to_plain(torch.from_numpy(db).to(cuda_device, dtype),
                   torch.from_numpy(qs).to(cuda_device, dtype), R, S, n_songs)


@pytest.mark.cuda
@pytest.mark.parametrize("key", sorted(WGMMA_BUILT))
def test_wgmma_instantiations_on_card(cuda_device, monkeypatch, key):
    """Every instantiation the source builds (the plans' and the sweep's)
    against the plain version, at B = 3 TN / 2 (a ragged query tile),
    stage 1's R = 40 for int8 (rows of a warp straddle songs) and R = 152
    for bf16; d past 1,536 for the int8 form of one block an SM and one
    warpgroup."""
    itemsize, rowsum, nwg, mt, pp, bps, tn = key
    dtype = torch.int8 if itemsize == 1 else torch.bfloat16
    d = 1600 if (nwg, bps) == (1, 1) else 128
    S = 40 if rowsum else 5 if itemsize == 1 else 19
    R, B, n_songs = (40 if itemsize == 1 else 152) + S, max(1, 3 * tn // 2), 97
    rng = np.random.default_rng(tn)
    if dtype == torch.int8:
        db = rng.integers(-127, 128, size=(n_songs * R, d)).astype(np.int8)
        qs = rng.integers(-127, 128, size=(B, S, d)).astype(np.int8)
    else:
        db = _corpus(rng, np.full(n_songs, R), d)
        qs = (rng.standard_normal((B, S, d)) / np.sqrt(d)).astype(np.float32)
    base = align_kernel.wgmma_plan
    monkeypatch.setattr(align_kernel, "tile_plan", lambda *a: base(
        *a, config=(rowsum, nwg, mt, pp, bps), tn=tn))
    plan = align_kernel.tile_plan(B, S, d, itemsize, R, n_songs)
    assert (plan["tn"], plan["mt"], plan["pp"], plan["bps"]) == (tn, mt, pp, bps)
    _hold_to_plain(torch.from_numpy(db).to(cuda_device, dtype),
                   torch.from_numpy(qs).to(cuda_device, dtype), R, S, n_songs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("d,offset", [(12, 0), (20, 0), (128, 4), (36, 4)])
def test_wgmma_padding_on_card(cuda_device, dtype, d, offset):
    """Rows off 16 bytes (odd d) and views off 16-byte alignment go
    through the zero-padded or re-based copy; the result equals the plain
    version on the tensors as given."""
    rng = np.random.default_rng(d + offset)
    db, qs, R = _card_case(rng, dtype, 33, 19 if dtype == torch.bfloat16 else 5, d, 29)
    item = torch.empty((), dtype=dtype).element_size()
    flat = torch.zeros(db.size + offset // item, dtype=dtype, device=cuda_device)
    view = flat[offset // item:].view(db.shape)
    view.copy_(torch.from_numpy(db).to(cuda_device, dtype))
    assert (view.data_ptr() % 16 == 0) == (offset == 0)
    _hold_to_plain(view, torch.from_numpy(qs).to(cuda_device, dtype), R, qs.shape[1], 29)
