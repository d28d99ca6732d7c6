from pfann_tpu_torch.landmark.core import (
    LandmarkIndex,
    extract_hashes,
    find_peaks,
    spectrogram,
)

__all__ = ["LandmarkIndex", "extract_hashes", "find_peaks", "spectrogram"]
