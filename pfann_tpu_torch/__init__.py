"""pfann_tpu_torch: the PyTorch/CUDA port of pfann_tpu's serving slice.

The JAX package ``pfann_tpu`` is the reference; this package holds the
same main path (DB build and serving) for one NVIDIA H100: log-mel,
FpNetwork, the exhaustive alignment engine with its hand-written CUDA
align-reduce kernel (``csrc/align_reduce.cu``), the Database and the
``builder``/``matcher`` entry points.  It imports torch and never jax or
flax; the JAX-free host modules of ``pfann_tpu`` (audio decode,
``MusicDataset``, config and logging) are reused as they are.

Layout mirrors ``pfann_tpu``: ``ops/``, ``models/``, ``index/``, ``utils/``.
"""

__version__ = "0.1.0"
