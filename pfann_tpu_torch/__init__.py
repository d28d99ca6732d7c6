"""pfann_tpu_torch: the PyTorch/CUDA port of pfann_tpu's serving slice.

The JAX package ``pfann_tpu`` is the reference; this package holds the
same main path (DB build and serving) for one NVIDIA H100: log-mel,
FpNetwork, the exhaustive and screened alignment engines with their
hand-written CUDA align-reduce kernel (``csrc/align_reduce.cu``), the
Database and the ``builder``/``matcher`` entry points.  It imports torch
and nothing of jax, flax or ``pfann_tpu``: the host modules it needs
(audio decode and resample, ``MusicDataset``, config and logging) are
copies in ``audio/``, ``data/`` and ``utils/``.

Layout mirrors ``pfann_tpu``: ``audio/``, ``data/``, ``ops/``, ``models/``,
``index/``, ``utils/``.
"""

__version__ = "0.1.0"
