"""The port's host tools: each ``python -m pfann_tpu_torch.tools.<name>``
takes the argv of ``tools/<name>.py`` (``createdataset`` that of
``denoise/createdataset.py``) and writes the same bytes."""
