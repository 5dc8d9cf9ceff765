"""Feature pipeline stages: extraction and matching against the database."""

from monocularsfm_torch.features.extraction import FeatureExtractor
from monocularsfm_torch.features.matching import (
    BruteFeatureMatcher,
    SequentialFeatureMatcher,
)

__all__ = [
    "FeatureExtractor",
    "SequentialFeatureMatcher",
    "BruteFeatureMatcher",
]
