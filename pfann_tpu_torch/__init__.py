"""pfann_tpu_torch: the PyTorch/CUDA port of pfann_tpu.

The JAX package ``pfann_tpu`` is the reference; this package holds the
same main path (DB build and serving) for one NVIDIA H100: log-mel,
FpNetwork, the exhaustive and screened alignment engines with their
hand-written CUDA align-reduce kernel (``csrc/align_reduce.cu``), the
Database and the ``builder``/``matcher`` entry points; the landmark arm
(``landmark/``, ``lm_builder``, ``lm_matcher``) and the host tools
(``tools/``).  It imports torch and nothing of jax, flax or
``pfann_tpu``: the host modules it needs (audio decode and resample,
``MusicDataset``, config and logging, the landmark core) are copies in
``audio/``, ``data/``, ``utils/`` and ``landmark/``.

Layout mirrors ``pfann_tpu``: ``audio/``, ``data/``, ``ops/``, ``models/``,
``index/``, ``landmark/``, ``utils/``.
"""

__version__ = "0.1.0"
