"""NT-Xent contrastive loss (port of ``pfann_tpu/train/loss.py``).

Rows are interleaved (org_0, aug_0, org_1, aug_1, ...).  For row i:

    L_i = -(a[i, partner(i)] - logsumexp_{k != i} a[i, k]),
    a = y y^T / tau,  partner(i) = i XOR 1,

and the loss is the mean over rows.  Masking the diagonal with -inf in the
logsumexp equals the reference's deletion of column i.

The [n, n] similarity is computed in true f32, as JAX computes it at
``Precision.HIGHEST``: on a card the product and both products of its
backward run with TF32 off, and the caller's TF32 setting is restored
afterwards.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def f32_matmul():
    """TF32 off for the matmuls inside, the caller's setting restored."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


class _Gram(torch.autograd.Function):
    """y y^T with its forward and backward products in true f32."""

    @staticmethod
    def forward(ctx, y):
        ctx.save_for_backward(y)
        with f32_matmul():
            return y @ y.T

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        with f32_matmul():
            return (g + g.T) @ y


def similarity_loss(y: torch.Tensor, tau: float) -> torch.Tensor:
    """y: [n, d] L2-normalized embeddings, n even, rows interleaved
    (org, aug) pairs.  Returns the scalar loss (mean over rows), f32."""
    n = y.shape[0]
    a = _Gram.apply(y.float()) / tau
    diag = torch.eye(n, dtype=torch.bool, device=y.device)
    lse = torch.logsumexp(a.masked_fill(diag, float("-inf")), dim=1)
    rows = torch.arange(n, device=y.device)
    return (lse - a[rows, rows ^ 1]).mean()
