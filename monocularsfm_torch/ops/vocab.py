"""Visual-vocabulary retrieval: k-means training + TF-IDF scoring.

The port of monocularsfm_tpu/ops/vocab.py.  The reference declares a
vocabulary-tree matcher but never implements it
(include/Feature/FeatureMatching.h:137-141); the JAX package supplies it
with a flat vocabulary, and so does this port: exact nearest-word search is
one (N, 128) x (128, K) fp32 product and an argmax, which replaces the
tree's greedy descent.

* training: Lloyd k-means on unit-L2 descriptors (argmax similarity =
  argmin L2 distance), the per-word sums by `segment_sum`
  (utils/segment.py), in a fixed order on the card as in the reference;
* image signatures: TF-IDF-weighted bag-of-words vectors, L2-normalised;
* retrieval: image similarity = (I, K) x (K, I) product; the top-k partners
  per image, ties to the lower index as jax.lax.top_k breaks them.

The products are plain fp32 `torch.matmul` (TF32 off by the package's
precision pins).  The card sums each word in another fixed order than the
CPU, so its centroids differ from the CPU's by ulps and an argmax between
two equally near words can flip between the devices; on one device, one
input gives one vocabulary.
"""

from __future__ import annotations

import numpy as np
import torch

from monocularsfm_torch.utils.segment import segment_plan, segment_sum


def _kmeans_fit(desc: torch.Tensor, init_idx: torch.Tensor, num_words: int,
                iterations: int = 10) -> torch.Tensor:
    """Lloyd k-means on unit-L2 descriptors. desc: (N, D) -> (K, D) centroids.

    Empty clusters keep their previous centroid (standard fallback)."""
    c = desc[init_idx]
    ones = torch.ones(desc.shape[0], dtype=desc.dtype, device=desc.device)
    for _ in range(iterations):
        assign = torch.argmax(desc @ c.T, dim=1)
        sums = segment_sum(desc, segment_plan(assign, num_words))
        # Integer-valued f32 below 2^24: exact in any order of the adds.
        counts = torch.zeros(num_words, dtype=desc.dtype,
                             device=desc.device).index_add_(0, assign, ones)
        new = sums / torch.clamp(counts[:, None], min=1.0)
        new = torch.where(counts[:, None] > 0, new, c)
        # Re-normalise: words live on the unit sphere like the descriptors.
        c = new / torch.clamp(torch.linalg.norm(new, dim=1, keepdim=True), min=1e-12)
    return c


def train_visual_vocab(descriptors, num_words: int = 4096, iterations: int = 10,
                       max_train: int = 262144, seed: int = 0,
                       device="cuda") -> torch.Tensor:
    """Train a K-word visual vocabulary from (N, 128) unit-L2 descriptors
    (a host array).  The subsample and the initial words come from
    np.random.default_rng(seed) as in the JAX package, so both start from
    the same centroids.  Returns (K, 128) float32 on `device`."""
    rng = np.random.default_rng(seed)
    desc = np.asarray(descriptors, np.float32)
    if len(desc) > max_train:
        desc = desc[rng.choice(len(desc), max_train, replace=False)]
    if len(desc) < num_words:
        raise ValueError(
            f"need >= {num_words} training descriptors, got {len(desc)}")
    init = rng.choice(len(desc), num_words, replace=False)
    return _kmeans_fit(torch.from_numpy(desc).to(device),
                       torch.from_numpy(init).to(device), num_words, iterations)


def quantize(desc: torch.Tensor, mask: torch.Tensor, vocab: torch.Tensor,
             num_words: int) -> torch.Tensor:
    """Hard-assign descriptors (N, D) to words -> word-count histogram
    (num_words,); masked rows count zero."""
    assign = torch.argmax(desc @ vocab.T, dim=1)
    # Counts of 0/1 masks: integer-valued f32, exact in any order.
    return torch.zeros(num_words, dtype=torch.float32,
                       device=desc.device).index_add_(0, assign, mask.float())


def quantize_batch(bank: torch.Tensor, mask: torch.Tensor, vocab: torch.Tensor,
                   num_words: int) -> torch.Tensor:
    """Word histograms (I, K) of a whole bank (I, N, D), one image at a time
    (the (N, K) similarities of one image at a time stay small)."""
    return torch.stack([quantize(d, m, vocab, num_words)
                        for d, m in zip(bank, mask)])


def tfidf_signatures(histograms: torch.Tensor) -> torch.Tensor:
    """TF-IDF weight + L2-normalise per-image word histograms (I, K)."""
    num_images = histograms.shape[0]
    df = (histograms > 0).sum(0)                  # document frequency per word
    # Smoothed idf (+1 floor): with a small vocabulary every word can appear
    # in every image, and raw log(N/df) would zero out all signatures.
    idf = torch.log((1.0 + num_images) / (1.0 + df)) + 1.0
    sig = histograms * idf[None, :]
    return sig / torch.clamp(torch.linalg.norm(sig, dim=1, keepdim=True), min=1e-12)


def retrieve_top_k(signatures: torch.Tensor, num_neighbors: int):
    """Top-k most similar images per image (self excluded), ties to the
    lower index.  Returns (scores (I, k), indices (I, k))."""
    sims = signatures @ signatures.T
    sims = sims - 2.0 * torch.eye(sims.shape[0], dtype=sims.dtype,
                                  device=sims.device)  # exclude self
    scores, idx = torch.sort(sims, dim=1, descending=True, stable=True)
    return scores[:, :num_neighbors], idx[:, :num_neighbors]
