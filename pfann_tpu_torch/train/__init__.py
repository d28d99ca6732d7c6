"""Contrastive training on the port: NT-Xent loss, the per-epoch cosine
schedule and the trainer (``python -m pfann_tpu_torch.train``)."""
