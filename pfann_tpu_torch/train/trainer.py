"""Contrastive training loop (port of ``pfann_tpu/train/trainer.py``).

Parity target: reference train.py:54-262 —
  * NT-Xent over interleaved (org, aug) pairs, tau from config
  * SpecAugment applied batch-wide on the device (train.py:80-81)
  * Adam (lr 1e-4) or LAMB (wd 1e-6) (train.py:204-209)
  * CosineAnnealingWarmRestarts(T_0=epochs, eta_min=1e-7) stepped per
    epoch (train.py:60-61)
  * per-epoch validation ranking: rank of each val positive among all
    train + val-org embeddings; top-1/10/20/100 (train.py:111-163)
  * checkpoint / epochs.txt / date.txt / final model export contract
    (train.py:169-185,213-237)

The model is the port's FpNetwork with bf16 per layer (as in serving);
parameters and gradients stay float32.  No AMP GradScaler: bf16 needs no
loss scaling.  Each step's loss stays on the device; the losses are read
once per epoch.

Data parallelism (``group``, a ``torch.distributed`` group; the JAX
package's ``Trainer(mesh=...)``): every rank holds the whole model and its
contiguous block of each batch's global rows (``parallel.mesh.row_block``).
The step computes the FULL-batch NT-Xent, as the JAX mesh step does (every
row keeps all 2n-2 negatives): each rank embeds its block, the blocks are
gathered detached (written into a zero [n, d] buffer and summed, exact),
the rank's live block is put back in its place so that the gathered matrix
carries its gradient path, and the loss of the [n, d] matrix is
backpropagated.  Each rank's gradient is then dL/dtheta through its own
rows; their SUM (one all-reduce of the flattened gradients) is dL/dtheta,
so Adam or LAMB steps identically on every rank.  Rank 0 alone writes the
checkpoints, ``metrics.jsonl`` and ``model.msgpack`` (the others wait at a
barrier); every rank loads on resume and validates (the same ranks).
"""

from __future__ import annotations

import datetime
import json
import os
import shutil
import time
from typing import Any, Iterable

import numpy as np
import torch
import torch.distributed as dist

from pfann_tpu_torch.data.prefetch import prefetch
from pfann_tpu_torch.models.fp_network import build_fp_network, init_like_flax
from pfann_tpu_torch.ops.specaug import Draws, SpecAugment
from pfann_tpu_torch.parallel.mesh import row_block
from pfann_tpu_torch.train.loss import f32_matmul, similarity_loss
from pfann_tpu_torch.train.schedule import cosine_warm_restarts
from pfann_tpu_torch.utils import checkpoint as ckpt
from pfann_tpu_torch.utils.device import resolve_device
from pfann_tpu_torch.utils.logging import get_logger
from pfann_tpu_torch.utils.rng import seeded_generator


class Lamb(torch.optim.Optimizer):
    """``optax.lamb(learning_rate, weight_decay)`` in torch: Adam moments
    (b1 0.9, b2 0.999, eps 1e-6, bias-corrected), plus ``weight_decay``
    times the parameter on every tensor (no mask: biases and LayerNorm
    too), scaled per tensor by the trust ratio ||p|| / ||u|| (1 where
    either norm is 0), times -lr."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 1e-6):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["step"] = torch.tensor(0.0)
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                t = float(state["step"])  # a CPU tensor: no device sync
                m, v = state["exp_avg"], state["exp_avg_sq"]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                u = (m / (1 - b1**t)) / ((v / (1 - b2**t)).sqrt() + group["eps"])
                u.add_(p, alpha=group["weight_decay"])
                pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
                ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)
                p.add_(u * ratio, alpha=-group["lr"])
        return loss


def make_optimizer(params_cfg: dict[str, Any], parameters) -> torch.optim.Optimizer:
    """Adam lr=1e-4 default, or LAMB wd=1e-6 (train.py:204-209).  The lr
    is set per epoch through ``param_groups`` (:meth:`Trainer.set_lr`)."""
    lr = params_cfg.get("lr", 1e-4)
    if params_cfg.get("optimizer", "adam") == "lamb":
        return Lamb(parameters, lr=lr, weight_decay=1e-6)
    return torch.optim.Adam(parameters, lr=lr, eps=1e-8)


class MetricsWriter:
    """tensorboardX when available (parity with train.py:240-244) plus an
    always-on JSONL log in the model dir."""

    def __init__(self, model_dir: str, run_name: str):
        self.jsonl = open(os.path.join(model_dir, "metrics.jsonl"), "a")
        self.tb = None
        try:
            import tensorboardX

            self.tb = tensorboardX.SummaryWriter("runs/" + run_name)
        except ImportError:
            pass

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self.jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": step}) + "\n")
        self.jsonl.flush()
        if self.tb:
            self.tb.add_scalar(tag, value, step)

    def flush(self) -> None:
        if self.tb:
            self.tb.flush()

    def close(self) -> None:
        self.jsonl.close()
        if self.tb:
            self.tb.close()


class Trainer:
    def __init__(
        self,
        params: dict[str, Any],
        compute_dtype: torch.dtype = torch.bfloat16,
        device: torch.device | str = "cuda",
        group: dist.ProcessGroup | None = None,
    ):
        self.params = params
        self.device = resolve_device(device) if isinstance(device, str) else device
        self.group = group
        self.rank = dist.get_rank(group) if group is not None else 0
        self.world_size = dist.get_world_size(group) if group is not None else 1
        self.model = build_fp_network(params, compute_dtype=compute_dtype).to(self.device)
        self.tau = params.get("tau", 0.05)
        self.total_epoch = params.get("epoch", 100)
        self.specaug = SpecAugment(params)
        self.lr_fn = cosine_warm_restarts(
            params.get("lr", 1e-4), t0=self.total_epoch, eta_min=1e-7
        )
        self.optimizer: torch.optim.Optimizer | None = None
        # the last train_epoch's wall time, steps and loader phase split
        self.last_epoch_stats: dict[str, float] = {}

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 123) -> None:
        """Fresh weights (flax's initialisers, from ``seed``) and a fresh
        optimizer."""
        init_like_flax(self.model, torch.Generator().manual_seed(seed))
        self.optimizer = make_optimizer(self.params, self.model.parameters())
        self.sync_params()

    def _flat_collective(self, tensors, op) -> None:
        """``op`` on the tensors flattened into one buffer, then copied back."""
        tensors = list(tensors)
        flat = torch.cat([t.reshape(-1) for t in tensors])
        op(flat)
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(part.view_as(t))

    @torch.no_grad()
    def sync_params(self) -> None:
        """Rank 0's parameters on every rank (a no-op without a group)."""
        if self.group is not None:
            self._flat_collective(self.model.parameters(),
                                  lambda f: dist.broadcast(f, 0, group=self.group))

    @torch.no_grad()
    def all_reduce_grads(self) -> None:
        """Each parameter's gradient summed over the ranks, in one call."""
        self._flat_collective((p.grad for p in self.model.parameters()),
                              lambda f: dist.all_reduce(f, group=self.group))

    def gather_rows(self, y: torch.Tensor, n: int) -> torch.Tensor:
        """This rank's live embeddings y [r1 - r0, d] -> the global [n, d]
        (f32): the other ranks' blocks detached, this one's in its place."""
        r0, r1 = row_block(n, self.rank, self.world_size)
        y = y.float()
        buf = y.new_zeros(n, y.shape[1])
        buf[r0:r1] = y.detach()
        dist.all_reduce(buf, group=self.group)  # one nonzero block a row: exact
        return torch.cat([buf[:r0], y, buf[r1:]])

    def set_lr(self, epoch: int) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_fn(epoch)

    def train_step(self, x: torch.Tensor, draws: Draws, n: int | None = None
                   ) -> torch.Tensor:
        """One step on x [n, F, T] (interleaved (org, aug) rows, log-mel, on
        the model's device) with the SpecAugment mask of ``draws``.  With a
        group, x is this rank's block of the batch's n global rows.  Returns
        the loss as a device scalar; the gradients stay in ``.grad`` (with a
        group, summed over the ranks)."""
        x = self.specaug.augment(draws, x)
        self.optimizer.zero_grad(set_to_none=True)
        y = self.model(x)
        if self.group is not None:
            y = self.gather_rows(y, n)
        loss = similarity_loss(y, self.tau)
        loss.backward()
        if self.group is not None:
            self.all_reduce_grads()
        self.optimizer.step()
        return loss.detach()

    def opt_state(self) -> dict[str, Any]:
        """The optimizer's moments and step count by parameter name, the
        port's checkpoint layout of ``opt_state``."""
        names = {p: n for n, p in self.model.named_parameters()}
        out = {"optimizer": self.params.get("optimizer", "adam"), "step": 0,
               "exp_avg": {}, "exp_avg_sq": {}}
        for p, st in self.optimizer.state.items():
            out["step"] = int(st["step"])
            out["exp_avg"][names[p]] = st["exp_avg"]
            out["exp_avg_sq"][names[p]] = st["exp_avg_sq"]
        return out

    def load_opt_state(self, opt: dict[str, Any]) -> None:
        want = self.params.get("optimizer", "adam")
        if opt["optimizer"] != want:
            raise ValueError("checkpoint optimizer %r, config asks for %r"
                             % (opt["optimizer"], want))
        state = {}
        for i, (name, _) in enumerate(self.model.named_parameters()):
            if name in opt["exp_avg"]:
                state[i] = {"step": torch.tensor(float(opt["step"])),
                            "exp_avg": opt["exp_avg"][name],
                            "exp_avg_sq": opt["exp_avg_sq"][name]}
        sd = self.optimizer.state_dict()
        sd["state"] = state
        self.optimizer.load_state_dict(sd)

    # ------------------------------------------------------------------
    def train_epoch(self, loader, epoch: int, seed: int = 123) -> float:
        """One epoch over ``loader`` (through the prefetch thread); the
        SpecAugment draws of step s come from (seed, epoch, s), so a resumed
        run repeats an uninterrupted one.  Returns the mean loss."""
        logger = get_logger()
        loader.shuffle = True
        loader.eval_time_shift = False
        loader.augmented = True
        loader.set_epoch(epoch)
        self.set_lr(epoch)
        # with a group the loader yields this rank's rows of each global batch
        loader.part = (self.rank, self.world_size) if self.group is not None else None
        losses = []
        t0 = time.perf_counter()
        try:
            for step, x in enumerate(prefetch(iter(loader))):
                n = None
                if loader.part is not None:
                    x, n = x
                # the mock loader yields numpy; a blocking copy would first
                # wait for the card to finish the previous step
                x = torch.as_tensor(x).to(self.device, non_blocking=True)
                if loader.part is None:
                    x = x.reshape((-1,) + x.shape[2:])  # flatten pairs (train.py:80)
                draws = self.specaug.draw(seeded_generator(seed, epoch, step),
                                          x.shape[-2], x.shape[-1])
                losses.append(self.train_step(x, draws, n))
        finally:
            loader.part = None
        losses = torch.stack(losses).tolist() if losses else []
        seconds = time.perf_counter() - t0
        mean_loss = float(np.mean(losses)) if losses else float("nan")
        self.last_epoch_stats = dict(getattr(loader, "last_stats", {}),
                                     epoch_s=seconds, steps=len(losses))
        logger.info("epoch %d train loss %f (%.1fs)", epoch + 1, mean_loss, seconds)
        return mean_loss

    @torch.no_grad()
    def _embed_all(self, batches: Iterable, chunk: int = 1280) -> torch.Tensor:
        """Embed a stream of [n, F, T] batches (host or device) in slices
        of up to ``chunk`` rows; the [N, d] embeddings stay on the device.
        (The JAX package pads to one chunk shape to avoid recompiles; an
        embedding here does not depend on the rows beside it.)"""
        outs = [self.model(part) for x in batches
                for part in torch.as_tensor(x, dtype=torch.float32).to(self.device).split(chunk)]
        if not outs:
            return torch.zeros((0, self.model.d), device=self.device)
        return torch.cat(outs)

    @torch.no_grad()
    def ranks(self, train_loader, val_loader) -> np.ndarray:
        """Each val pair's rank (train.py:111-163): the count of train and
        val-org rows whose score against the pair's aug row is >= the
        pair's own score.  The train set is embedded clean (augmented=False,
        org crop only); the val set keeps augmentation on, so ranking
        measures retrieval of the noisy pair.  Rows are scored in chunks of
        4,096, the last padded with -10 rows, as the JAX package does."""
        for ld in (train_loader, val_loader):
            ld.shuffle = False
            ld.eval_time_shift = True
        train_loader.augmented = False
        val_loader.augmented = True

        x_embed = self._embed_all(torch.as_tensor(x)[:, 0] for x in train_loader)
        y_embed = self._embed_all(
            torch.as_tensor(x).reshape((-1,) + tuple(x.shape[2:])) for x in val_loader
        )
        y_org, y_aug = y_embed[0::2], y_embed[1::2]
        self_score = (y_org * y_aug).sum(dim=1)
        ranks = torch.zeros(y_org.shape[0], dtype=torch.int64, device=self.device)
        chunk = 4096
        with f32_matmul():
            for source in (x_embed, y_org):
                for i in range(0, source.shape[0], chunk):
                    part = source[i : i + chunk]
                    if part.shape[0] < chunk:
                        part = torch.cat([part, part.new_full(
                            (chunk - part.shape[0], part.shape[1]), -10.0)])
                    ranks += (part @ y_aug.T >= self_score[None, :]).sum(dim=0)
        return ranks.cpu().numpy()

    def validate(self, train_loader, val_loader) -> dict[str, float]:
        """Top-1/10/20/100 of :meth:`ranks` (a rank of 1 is a top-1 hit)."""
        ranks = self.ranks(train_loader, val_loader)
        v = max(len(ranks), 1)
        return {
            "accuracy": float((ranks == 1).sum() / v),
            "top10": float((ranks <= 10).sum() / v),
            "top20": float((ranks <= 20).sum() / v),
            "top100": float((ranks <= 100).sum() / v),
        }

    # ------------------------------------------------------------------
    def fit(self, train_loader, val_loader, config_path: str | None = None):
        """Full training with resume (train.py:54-262).  Returns the final
        state dict, or None when the model had finished training."""
        params_cfg = self.params
        model_dir = params_cfg["model_dir"]
        os.makedirs(model_dir, exist_ok=True)
        logger = get_logger()
        lead = self.rank == 0  # writes and prints; the other ranks wait

        self.init_state()
        start_epoch = ckpt.last_epoch(model_dir)
        self._barrier()  # every rank has read it before rank 0 writes more
        if start_epoch >= 0:
            if start_epoch + 1 >= self.total_epoch:
                if lead:
                    print("This model has finished training!")
                return None
            if lead:
                print("Load from epoch %d" % (start_epoch + 1))
            state = ckpt.load_checkpoint(model_dir, start_epoch)
            self.model.load_state_dict(state["params"])
            self.load_opt_state(state["opt_state"])
        elif config_path and lead:
            shutil.copyfile(config_path, os.path.join(model_dir, "configs.json"))

        writer = None
        if lead:
            date_path = os.path.join(model_dir, "date.txt")
            if os.path.exists(date_path):
                with open(date_path) as f:
                    date_str = f.read().strip()
            else:
                date_str = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
                with open(date_path, "w") as f:
                    f.write(date_str + "\n")
            safe_name = os.path.basename(os.path.normpath(model_dir))
            writer = MetricsWriter(model_dir, safe_name + "-" + date_str)
        try:
            for epoch in range(start_epoch + 1, self.total_epoch):
                if lead:
                    print("epoch %d" % (epoch + 1))
                mean_loss = self.train_epoch(train_loader, epoch)
                metrics = self.validate(train_loader, val_loader)
                if lead:
                    writer.add_scalar("train/loss", mean_loss, epoch)
                    for k, val in self.last_epoch_stats.items():
                        writer.add_scalar("train/" + k, val, epoch)
                    print("loss: %f" % mean_loss)
                    print("validate score: %f" % metrics["accuracy"])
                    print("validate top10: %f" % metrics["top10"])
                    writer.add_scalar("validation/accuracy", metrics["accuracy"], epoch)
                    writer.add_scalar("validation/top10", metrics["top10"], epoch)
                    writer.add_scalar("validation/top20", metrics["top20"], epoch)
                    writer.add_scalar("validation/top100", metrics["top100"], epoch)
                    writer.flush()
                    ckpt.save_checkpoint(model_dir, epoch, {
                        "epoch": epoch, "params": self.model.state_dict(),
                        "opt_state": self.opt_state()})
                self._barrier()
                logger.info("epoch %d done", epoch + 1)
        finally:
            if writer is not None:
                writer.close()

        state_dict = self.model.state_dict()
        if lead:
            ckpt.save_model(os.path.join(model_dir, ckpt.MODEL_FILE_NAME), state_dict)
        self._barrier()
        return state_dict

    def _barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)
