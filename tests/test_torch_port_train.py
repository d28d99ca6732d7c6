"""The port's training path against the JAX package's, on the CPU.

Tiny model (d=16, h=64, u=8, fuller), as tests/test_trainer.py.  JAX
calls are jitted; inputs come from numpy seeds.  Tolerances:
  * loss and d(loss)/dy: rtol 1e-5, atol 1e-6 (f32 sums in other orders).
  * schedule: equal floats.
  * SpecAugment: the mask from JAX's own draws equal to JAX's mask.
  * one train step in f32 compute: loss rtol 1e-5; each leaf's grad
    within 5e-4 of its norm in L2 (measured <= 8.2e-5: XLA and torch sum
    the convs and LayerNorm statistics in other orders); params after the
    step within 1e-3 * lr on >= 99.9% of entries and within 0.5 * lr on
    all (measured 0.16-0.21 lr): the first Adam/LAMB step is ~lr * sign(g),
    so an entry whose g lies within rounding of 0 moves by a fraction of lr.
  * one train step in bf16 compute (loose): loss rtol 1e-2; each leaf's
    grad no further from JAX's bf16 grad than twice JAX's own bf16 grad is
    from its f32 grad (measured <= 1.66x: at this width bf16 moves single
    leaves by 10-50%), and the whole gradient's cosine with JAX's >= 0.95;
    params after the step within 1e-2 * lr of JAX's on >= 90% of entries.
    Both packages round each conv's operands to bf16 but round the sums at
    other points, and autograd differentiates the port's f32-on-bf16 CPU
    conv.
  * LAMB against optax.lamb: rtol 1e-5, atol 1e-7 after 5 steps.
  * validation metrics, fit-then-resume and checkpoints: equal.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import flax.serialization as fser
import jax
import jax.numpy as jnp
import optax

from pfann_tpu.data.mock import MockedDataLoader as JaxMock
from pfann_tpu.ops.specaug import SpecAugment as JaxSpecAugment
from pfann_tpu.train.loss import similarity_loss as jax_loss
from pfann_tpu.train.schedule import cosine_warm_restarts as jax_schedule
from pfann_tpu.train.trainer import Trainer as JaxTrainer
from pfann_tpu.utils import checkpoint as jckpt
from pfann_tpu_torch.data.mock import MockedDataLoader
from pfann_tpu_torch.ops.specaug import SpecAugment
from pfann_tpu_torch.train.loss import similarity_loss
from pfann_tpu_torch.train.schedule import cosine_warm_restarts
from pfann_tpu_torch.train.trainer import Lamb, Trainer
from pfann_tpu_torch.utils import checkpoint as ckpt
from pfann_tpu_torch.utils.checkpoint import params_from_flax
from pfann_tpu_torch.utils.rng import seeded_generator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {
    "model_dir": None,
    "batch_size": 16,
    "shuffle_size": None,
    "sample_rate": 8000,
    "stft_n": 1024,
    "stft_hop": 256,
    "n_mels": 256,
    "f_min": 300,
    "f_max": 4000,
    "segment_size": 1,
    "hop_size": 0.5,
    "epoch": 2,
    "lr": 1e-3,
    "tau": 0.05,
    "cutout_min": 0.1,
    "cutout_max": 0.5,
    "mock_sizes": [48, 16],
    "model": {"d": 16, "h": 64, "u": 8, "fuller": True},
}


@pytest.fixture(autouse=True)
def _few_threads(monkeypatch):
    """Two torch threads here and in child processes: the suite runs
    several workers on one machine, and torch's thread pools in each,
    spinning over all cores, slowed these tests tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    yield
    torch.set_num_threads(n)


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _jax_draws(key, F, T, lo=0.1, hi=0.5):
    """JAX's SpecAugment draws for ``key``, replayed from
    pfann_tpu/ops/specaug.py:27-35 as (start, extent) per side."""
    kf, kf0, kt, kt0, kf2, kf02, kt2, kt02 = jax.random.split(key, 8)

    def side(size, kk, kk0):
        frac = lo + jax.random.uniform(kk) * (hi - lo)
        ext = jnp.floor(size * frac).astype(jnp.int32)
        start = jax.random.randint(kk0, (), 0, size - ext + 1)
        return int(start), int(ext)

    return side(F, kf, kf0), side(T, kt, kt0), side(F, kf2, kf02), side(T, kt2, kt02)


# ----------------------------------------------------------------- loss
@pytest.mark.parametrize("n,d,tau", [(8, 16, 0.05), (24, 128, 0.1)])
def test_loss_and_grad_match_jax(n, d, tau):
    rng = np.random.default_rng(n)
    y = rng.standard_normal((n, d)).astype(np.float32)
    y /= np.linalg.norm(y, axis=1, keepdims=True)
    want, want_g = jax.jit(jax.value_and_grad(jax_loss), static_argnums=1)(jnp.asarray(y), tau)
    yt = torch.from_numpy(y).requires_grad_(True)
    got = similarity_loss(yt, tau)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-6)


def test_loss_of_random_embeddings_is_near_log_n_minus_1():
    y = torch.nn.functional.normalize(torch.randn(640, 128, generator=torch.Generator().manual_seed(0)), dim=1)
    assert abs(float(similarity_loss(y, 1.0)) - np.log(639)) < 0.05 * np.log(639)


# ------------------------------------------------------------- schedule
@pytest.mark.parametrize("t_mult", [1, 2])
def test_schedule_equals_jax(t_mult):
    want = jax_schedule(1e-4, 5, t_mult=t_mult)
    got = cosine_warm_restarts(1e-4, 5, t_mult=t_mult)
    assert [got(e) for e in range(40)] == [want(e) for e in range(40)]


# ---------------------------------------------------------- SpecAugment
@pytest.mark.parametrize("seed", range(6))
def test_specaug_mask_from_jax_draws(seed):
    key = jax.random.key(seed)
    F, T = 256, 32
    want = np.asarray(jax.jit(JaxSpecAugment(TINY).get_mask, static_argnums=(1, 2))(key, F, T))
    got = SpecAugment(TINY).get_mask(_jax_draws(key, F, T), F, T).numpy()
    np.testing.assert_array_equal(got, want)


def test_specaug_draws_in_range_and_one_mask_per_batch():
    sa = SpecAugment(TINY)
    F, T = 256, 32
    for step in range(200):
        draws = sa.draw(seeded_generator(123, 0, step), F, T)
        for (start, ext), size in zip(draws, (F, T, F, T)):
            assert int(size * 0.1) <= ext <= int(size * 0.5)
            assert 0 <= start and start + ext <= size
    assert sa.draw(seeded_generator(1, 2, 3), F, T) == sa.draw(seeded_generator(1, 2, 3), F, T)
    x = torch.rand(6, F, T, generator=torch.Generator().manual_seed(0)) + 1.0
    y = sa.augment(draws, x)
    erased = y == 0
    assert erased.any() and (erased == erased[0]).all()
    assert torch.equal(y[~erased], x[~erased])


# ----------------------------------------------------------------- init
def test_init_like_flax_matches_jax_distribution():
    jt = JaxTrainer(TINY, compute_dtype=jnp.float32)
    jparams, _ = jt.init_state()
    want = params_from_flax(_torch_tree(jparams))
    tr = Trainer(TINY, compute_dtype=torch.float32, device="cpu")
    tr.init_state()
    got = tr.model.state_dict()
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if w.numel() < 200 or w.std() == 0:
            # biases and LayerNorm affine: constants, equal
            if w.std() == 0:
                assert torch.equal(g, w), name
            continue
        # truncated normals with the same scale: std within 10%, same bound
        assert abs(float(g.std()) / float(w.std()) - 1) < 0.1, name
        bound = float(w.abs().max())
        assert float(g.abs().max()) <= bound * 1.05 + 1e-6, name


# ----------------------------------------------------------- train step
def _jax_grads(jt, params, x, key):
    def loss_fn(p):
        return jax_loss(jt.model.apply(p, jt.specaug.augment(key, x)), jt.tau)

    return jax.jit(jax.value_and_grad(loss_fn))(params)


@pytest.mark.parametrize("optimizer", ["adam", "lamb"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_jax(optimizer, dtype):
    cfg = dict(TINY, optimizer=optimizer)
    jt = JaxTrainer(cfg, compute_dtype=getattr(jnp, dtype))
    params, opt_state = jt.init_state(seed=5)
    params_np = jax.tree.map(np.array, params)
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((16, 256, 32)) * 2 - 4).astype(np.float32)
    key = jax.random.key(3)
    want_loss, want_g = _jax_grads(jt, params, jnp.asarray(x), key)
    new_params, _, step_loss = jt.train_step(params, opt_state, jnp.asarray(x), key)
    np.testing.assert_allclose(float(step_loss), float(want_loss), rtol=1e-6)

    tr = Trainer(cfg, compute_dtype=getattr(torch, dtype), device="cpu")
    tr.init_state()
    tr.model.load_state_dict(params_from_flax(_torch_tree(params_np)))
    loss = tr.train_step(torch.from_numpy(x), _jax_draws(key, 256, 32))
    grads = {n: p.grad for n, p in tr.model.named_parameters()}
    want_g = params_from_flax(_torch_tree(want_g))
    got_p = tr.model.state_dict()
    want_p = params_from_flax(_torch_tree(new_params))
    old_p = params_from_flax(_torch_tree(params_np))
    lr = cfg["lr"]
    diff = torch.cat([(got_p[n] - w).abs().flatten() for n, w in want_p.items()])
    if dtype == "float32":
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
        for n, g in want_g.items():
            assert float((grads[n] - g).norm()) <= 5e-4 * float(g.norm()), n
        assert float((diff <= 1e-3 * lr).float().mean()) >= 0.999
        assert float(diff.max()) <= 0.5 * lr
    else:
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-2)
        jt32 = JaxTrainer(cfg, compute_dtype=jnp.float32)
        g32 = params_from_flax(_torch_tree(_jax_grads(jt32, params_np, jnp.asarray(x), key)[1]))
        for n, g in want_g.items():
            assert float((grads[n] - g).norm()) <= 2 * float((g - g32[n]).norm()), n
        flat = [torch.cat([d[n].flatten() for n in want_g]) for d in (grads, want_g)]
        assert float(torch.nn.functional.cosine_similarity(*flat, dim=0)) >= 0.95
        assert float((diff <= 1e-2 * lr).float().mean()) >= 0.90
    # the step moved the weights
    assert any(not torch.equal(got_p[n], old_p[n]) for n in old_p)


def test_lamb_matches_optax():
    rng = np.random.default_rng(2)
    shapes = {"a": (4, 6), "b": (7,), "z": (3, 3), "c": (2, 3, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    params["z"][:] = 0  # a zero-norm leaf: both norms 0, trust ratio 1
    grads = [{k: rng.standard_normal(s).astype(np.float32) * 10.0 ** -i
              for k, s in shapes.items()} for i in range(5)]
    for g in grads:
        g["z"][:] = 0
    tx = optax.lamb(3e-2, weight_decay=1e-6)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    step = jax.jit(lambda p, s, g: (lambda u, s2: (optax.apply_updates(p, u), s2))(*tx.update(g, s, p)))
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = Lamb(tp.values(), lr=3e-2, weight_decay=1e-6)
    for g in grads:
        jp, state = step(jp, state, jax.tree.map(jnp.asarray, g))
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-7)
    assert not tp["z"].detach().any()


# ----------------------------------------------------------- validation
def _jax_ranks(jt, params, cfg):
    """JAX's validation ranks, replayed from pfann_tpu/train/trainer.py:
    226-268 (``validate`` returns only the metrics)."""
    train, val = JaxMock("train", cfg), JaxMock("validate", cfg)
    for ld in (train, val):
        ld.shuffle = False
        ld.eval_time_shift = True
    train.augmented = False
    x_embed = jt._embed_all(params, (jnp.asarray(x)[:, 0] for x in train))
    y_embed = jt._embed_all(params, (jnp.asarray(x).reshape((-1,) + x.shape[2:]) for x in val))
    y_org, y_aug = y_embed[0::2], y_embed[1::2]
    self_score = jnp.asarray(np.sum(y_org * y_aug, axis=1))
    ranks = np.zeros(y_org.shape[0], np.int64)
    for source in (x_embed, y_org):
        part = np.concatenate([source, np.full((4096 - len(source), source.shape[1]), -10.0, np.float32)])
        ranks += np.asarray(jt.rank_step(jnp.asarray(part), jnp.asarray(y_aug), self_score))
    return ranks


def test_validate_matches_jax(tmp_path):
    """Equal up to last-bit ties.  A row's rank counts scores >= its own
    pair's score, and its own pair (and any near-equal row) compares at
    the last bit: XLA's and torch's matmuls round differently, so each
    rank may differ from JAX's by 1, and a metric only by the rows whose
    JAX rank lies within 1 of its threshold (for top-1, ranks 0-2)."""
    cfg = dict(TINY, model_dir=str(tmp_path / "m"))
    jt = JaxTrainer(cfg, compute_dtype=jnp.float32)
    params, _ = jt.init_state(seed=9)
    want = jt.validate(params, JaxMock("train", cfg), JaxMock("validate", cfg))
    want_r = _jax_ranks(jt, params, cfg)
    v = len(want_r)
    assert want["accuracy"] == (want_r == 1).sum() / v
    tr = Trainer(cfg, compute_dtype=torch.float32, device="cpu")
    tr.init_state()
    tr.model.load_state_dict(params_from_flax(_torch_tree(params)))
    got_r = tr.ranks(MockedDataLoader("train", cfg), MockedDataLoader("validate", cfg))
    assert np.abs(got_r - want_r).max() <= 1
    got = tr.validate(MockedDataLoader("train", cfg), MockedDataLoader("validate", cfg))
    for key, k in (("accuracy", 1), ("top10", 10), ("top20", 20), ("top100", 100)):
        lo = 0 if k == 1 else k
        ties = int((np.abs(want_r - lo) <= 1).sum() + (np.abs(want_r - k - 1) <= 0).sum())
        assert abs(got[key] - want[key]) * v <= ties, key


# ------------------------------------------------------ fit and resume
def _loaders(cfg):
    train, val = MockedDataLoader("train", cfg), MockedDataLoader("validate", cfg)
    val.shuffle = False
    val.eval_time_shift = True
    return train, val


@pytest.mark.parametrize("optimizer", ["adam", "lamb"])
def test_fit_then_resume_equals_uninterrupted_fit(tmp_path, monkeypatch, optimizer):
    monkeypatch.chdir(tmp_path)  # tensorboardX writes runs/ under the cwd
    full = dict(TINY, model_dir=str(tmp_path / "full"), optimizer=optimizer)
    want = Trainer(full, compute_dtype=torch.float32, device="cpu").fit(*_loaders(full))

    part = dict(full, model_dir=str(tmp_path / "part"))
    first = Trainer(part, compute_dtype=torch.float32, device="cpu")
    first.total_epoch = 1  # stop after epoch 0; the schedule still spans 2
    first.fit(*_loaders(part))
    assert ckpt.last_epoch(part["model_dir"]) == 0
    got = Trainer(part, compute_dtype=torch.float32, device="cpu").fit(*_loaders(part))
    assert sorted(got) == sorted(want)
    for n in want:
        assert torch.equal(got[n], want[n]), n
    a = ckpt.load_checkpoint(full["model_dir"], 1)
    b = ckpt.load_checkpoint(part["model_dir"], 1)
    assert a["epoch"] == b["epoch"] == 1
    assert a["opt_state"]["step"] == b["opt_state"]["step"] == 12
    for k in ("exp_avg", "exp_avg_sq"):
        for n, t in a["opt_state"][k].items():
            assert torch.equal(t, b["opt_state"][k][n]), (k, n)

    md = full["model_dir"]
    for name in ("checkpoint0.ckpt", "checkpoint1.ckpt", "epochs.txt", "date.txt",
                 "metrics.jsonl", "model.msgpack"):
        assert os.path.exists(os.path.join(md, name)), name
    tags = {json.loads(ln)["tag"] for ln in open(os.path.join(md, "metrics.jsonl"))}
    assert {"train/loss", "train/epoch_s", "train/steps", "validation/accuracy",
            "validation/top10", "validation/top20", "validation/top100"} <= tags
    # finished: no more training
    assert Trainer(full, compute_dtype=torch.float32, device="cpu").fit(*_loaders(full)) is None

    # the JAX package reads the port's model.msgpack and checkpoint params
    jt = JaxTrainer(full, compute_dtype=jnp.float32)
    target, _ = jt.init_state()
    jm = jckpt.load_model(md, target)
    with open(os.path.join(md, "checkpoint1.ckpt"), "rb") as f:
        jc = fser.from_state_dict(target, fser.msgpack_restore(f.read())["params"])
    for tree in (jm, jc):
        sd = params_from_flax(_torch_tree(tree))
        for n in want:
            assert torch.equal(sd[n], want[n]), n


def test_checkpoint_retention_equals_jax(tmp_path):
    sd = {"g.b2": torch.zeros(2, 1)}
    for e in range(23):
        ckpt.save_checkpoint(str(tmp_path / "port"), e, {
            "epoch": e, "params": sd,
            "opt_state": {"optimizer": "adam", "step": e, "exp_avg": {}, "exp_avg_sq": {}}})
        jckpt.save_checkpoint(str(tmp_path / "jax"), e, {"epoch": e})
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert ckpt.last_epoch(str(tmp_path / "port")) == jckpt.last_epoch(str(tmp_path / "jax")) == 22
    assert ckpt.last_epoch(str(tmp_path / "none")) == -1


def _jax_checkpoint(model_dir, cfg):
    jt = JaxTrainer(cfg, compute_dtype=jnp.float32)
    params, opt_state = jt.init_state(seed=4)
    jckpt.save_checkpoint(model_dir, 0, {"epoch": 0, "params": params, "opt_state": opt_state})
    return params


def test_resume_from_jax_checkpoint_raises(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = dict(TINY, model_dir=str(tmp_path / "m"))
    _jax_checkpoint(cfg["model_dir"], cfg)
    with pytest.raises(ValueError, match="optimizer state this package did not write"):
        Trainer(cfg, compute_dtype=torch.float32, device="cpu").fit(*_loaders(cfg))


# ------------------------------------------------------------------ CLI
def test_train_cli_mock(tmp_path, monkeypatch, capsys):
    from pfann_tpu_torch.train.__main__ import main

    cfg = dict(TINY, model_dir=str(tmp_path / "m"), epoch=1)
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    argv = ["-p", cfg_path, "--mock", "-w", "0"]
    r = subprocess.run([sys.executable, "-m", "pfann_tpu_torch.train"] + argv
                       + ["--dp", "--device", "cpu"], cwd=tmp_path,
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "validate score" in r.stdout
    md = cfg["model_dir"]
    for name in ("checkpoint0.ckpt", "epochs.txt", "date.txt", "configs.json",
                 "metrics.jsonl", "model.msgpack"):
        assert os.path.exists(os.path.join(md, name)), name
    monkeypatch.chdir(tmp_path)  # the CLI logs under ./logs
    main(["train"] + argv + ["--device", "cpu"])
    assert "This model has finished training!" in capsys.readouterr().out
    # cuda is the default and raises without a card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main(["train"] + argv)


# ---------------------------------------------------------------- tools
def test_export_model_from_port_and_jax_checkpoints(tmp_path):
    from pfann_tpu_torch.tools import export_model

    cfg = dict(TINY, model_dir=str(tmp_path / "m"))
    md = cfg["model_dir"]
    jparams = _jax_checkpoint(md, cfg)
    with open(os.path.join(md, "configs.json"), "w") as f:
        json.dump(cfg, f)
    export_model.main(["export_model", md, "0"])
    got = ckpt.load_model(md)
    want = params_from_flax(_torch_tree(jparams))
    assert all(torch.equal(got[n], want[n]) for n in want)

    sd = {n: torch.randn(t.shape, generator=torch.Generator().manual_seed(1)) for n, t in want.items()}
    ckpt.save_checkpoint(md, 1, {"epoch": 1, "params": sd, "opt_state": {
        "optimizer": "adam", "step": 1, "exp_avg": {}, "exp_avg_sq": {}}})
    export_model.main(["export_model", md])  # the last epoch, 1
    got = ckpt.load_model(md)
    assert all(torch.equal(got[n], sd[n]) for n in sd)


def test_cosinedecay_equals_jax_tool(tmp_path, monkeypatch, capsys, run_cli):
    from pfann_tpu_torch.tools import cosinedecay

    out = tmp_path / "lr.png"
    cosinedecay.main(["cosinedecay", "--epochs", "12", "-o", str(out)])
    assert out.stat().st_size > 0 and "saved" in capsys.readouterr().out
    # without matplotlib both tools print the same values and exit nonzero
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    argv = ["--epochs", "12", "--lr", "3e-4", "--t0", "5"]
    with pytest.raises(SystemExit, match="matplotlib not available"):
        cosinedecay.main(["cosinedecay"] + argv)
    got = capsys.readouterr().out
    with pytest.raises(AssertionError, match="matplotlib not available"):
        run_cli(os.path.join(REPO, "tools", "cosinedecay.py"), argv)
    want = capsys.readouterr().out
    assert got == want and len(got.splitlines()) == 12
