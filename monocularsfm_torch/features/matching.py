"""Matching stage: pair scheduling on host, batched matching on the device.

The port of monocularsfm_tpu/features/matching.py (reference parity:
src/Feature/FeatureMatching.cpp — skip-if-exists -> cross/ratio match ->
distance filter -> F-RANSAC verification -> WriteMatches :10-73; sequential
:75-100; brute with the optional VisualSFM preemptive filter :102-178).
Descriptors live in a device-resident bf16 bank; the host decides which
pairs to run, each batch of pairs is one `match_pairs_batch` call (kernel 3
on the card), and geometric verification is hypothesis-parallel F-RANSAC
whose uniform draws come from the matcher's own torch.Generator.
"""

from __future__ import annotations

import numpy as np
import torch

from monocularsfm_torch.config import MatchingConfig
from monocularsfm_torch.database import Database
from monocularsfm_torch.estimators import (
    estimate_fundamental_ransac_batch,
    rounds_to_confidence,
)
from monocularsfm_torch.ops.matching import match_pairs_batch, matches_to_pairs


def _pad_pow2(n: int, minimum: int = 1024) -> int:
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


class _MatcherBase:
    def __init__(self, config: MatchingConfig | None = None, device="cuda"):
        self.cfg = config or MatchingConfig()
        if self.cfg.backend != "jax":
            raise ValueError(
                f"matching backend {self.cfg.backend!r} is not ported; "
                "the device path is backend 'jax'")
        self.device = torch.device(device)
        self._gen = torch.Generator(self.device).manual_seed(1234)

    # -- descriptor bank -----------------------------------------------------
    def _load_bank(self, db: Database, image_ids: list[int]):
        """Device-resident (I, cap, 128) bf16 bank + masks + keypoints.  The
        matcher rounds descriptors to bf16 before its product anyway, so the
        bf16 bank is output-preserving and halves the upload."""
        descs = {}
        kps = {}
        cap = 0
        for i in image_ids:
            d = db.read_descriptors(i)
            k = db.read_keypoints(i)
            if d is None or k is None:
                raise KeyError(f"image {i} has no features in the database")
            descs[i] = d
            kps[i] = k
            cap = max(cap, len(d))
        cap = _pad_pow2(cap)
        bank = np.zeros((len(image_ids), cap, 128), np.float32)
        mask = np.zeros((len(image_ids), cap), bool)
        for row, i in enumerate(image_ids):
            n = len(descs[i])
            bank[row, :n] = descs[i]
            mask[row, :n] = True
        bank_t = torch.from_numpy(bank).to(torch.bfloat16).to(self.device)
        return bank_t, torch.from_numpy(mask).to(self.device), kps, cap

    # -- geometric verification ---------------------------------------------
    def _verify_batch(self, uv_pairs: list[tuple[np.ndarray, np.ndarray]]):
        """F-RANSAC inlier masks for a batch of pairs (FeatureUtils::
        FilterMatches semantics).  uv_pairs: [(uv1 (n_i, 2), uv2 (n_i, 2)),
        ...].  Returns a list of bool (n_i,) inlier masks."""
        if not uv_pairs:
            return []
        Bc = _pad_pow2(len(uv_pairs), minimum=min(8, self.cfg.pair_batch))
        cap = _pad_pow2(max(len(a) for a, _ in uv_pairs), minimum=512)
        x1 = np.zeros((Bc, cap, 2), np.float32)
        x2 = np.zeros((Bc, cap, 2), np.float32)
        m = np.zeros((Bc, cap), bool)
        for p, (uv1, uv2) in enumerate(uv_pairs):
            n = len(uv1)
            x1[p, :n], x2[p, :n], m[p, :n] = uv1, uv2, n >= 8
        x1t, x2t, mt = (torch.from_numpy(v).to(self.device) for v in (x1, x2, m))
        M = self.cfg.ransac_iterations

        def run_round():
            u = torch.rand((Bc, M, cap), generator=self._gen, device=self.device)
            out = estimate_fundamental_ransac_batch(
                u, x1t, x2t, mt, threshold_px=self.cfg.ransac_threshold_px)
            return out["inliers"].cpu().numpy()

        # Adaptive continuation to `ransac_confidence`: while any pair's best
        # model leaves the 1-(1-w^8)^k bound unmet, run another round of the
        # same shape and keep the per-pair better model.
        inl = run_round()
        counts = inl.sum(axis=1)
        nvalid = m.sum(axis=1)
        rounds = 1
        while rounds < max(
            (
                rounds_to_confidence(
                    self.cfg.ransac_confidence, int(c), int(v), 8, M)
                for c, v in zip(counts[: len(uv_pairs)], nvalid[: len(uv_pairs)])
                if v >= 8
            ),
            default=1,
        ):
            inl2 = run_round()
            counts2 = inl2.sum(axis=1)
            better = counts2 > counts
            inl[better] = inl2[better]
            counts = np.maximum(counts, counts2)
            rounds += 1
        return [inl[p, : len(a)] for p, (a, _) in enumerate(uv_pairs)]

    # -- one batched call over a pair slab ------------------------------------
    def _match_and_verify_pairs(self, db, bank, mask, kps, image_ids, pairs,
                                log=print) -> int:
        """pairs: list of (image_id_a, image_id_b). Returns #pairs written."""
        row_of = {i: r for r, i in enumerate(image_ids)}
        written = 0
        B = self.cfg.pair_batch
        for start in range(0, len(pairs), B):
            chunk = [
                (a, b) for a, b in pairs[start : start + B]
                if not db.exist_matches(a, b)
            ]
            if not chunk:
                continue
            # Pad the chunk to the fixed batch width.
            padded = chunk + [chunk[-1]] * (B - len(chunk))
            ids = [[row_of[a], row_of[b]] for a, b in padded]
            idx_b = match_pairs_batch(
                bank, mask, ids,
                ratio=self.cfg.distance_ratio,
                max_distance=self.cfg.max_distance,
                cross_check=self.cfg.cross_check,
            ).cpu().numpy()
            # Verify the whole chunk's raw matches in one batched F-RANSAC.
            to_verify = []   # (a, b, i_idx, j_idx)
            uv_pairs = []
            for p, (a, b) in enumerate(chunk):
                i_idx, j_idx = matches_to_pairs(idx_b[p])
                if len(i_idx) < self.cfg.min_num_matches_verified:
                    db.write_matches(a, b, np.zeros((0, 2), np.int32))
                    continue
                to_verify.append((a, b, i_idx, j_idx))
                uv_pairs.append((kps[a][i_idx, :2], kps[b][j_idx, :2]))
            for (a, b, i_idx, j_idx), inl in zip(
                to_verify, self._verify_batch(uv_pairs)
            ):
                m = np.stack([i_idx[inl], j_idx[inl]], axis=1).astype(np.int32)
                if len(m) < self.cfg.min_num_matches_verified:
                    m = np.zeros((0, 2), np.int32)
                db.write_matches(a, b, m)
                written += 1
                log(f"[match] ({a},{b}): {len(i_idx)} raw -> {len(m)} verified")
        return written

    # -- preemptive filter (VisualSFM / Wu 2013) -----------------------------
    def _preemptive_keep(self, db, image_ids, pairs, log=print):
        """Match top-scale descriptor subsets; keep pairs with >= threshold
        matches (FeatureMatching.cpp:148-178)."""
        cfg = self.cfg
        sub = {}
        for i in image_ids:
            d = db.read_descriptors(i)
            k = db.read_keypoints(i)
            order = np.argsort(-k[:, 2], kind="stable")[: cfg.preemptive_num_features]
            sub[i] = d[order]
        cap = _pad_pow2(cfg.preemptive_num_features, minimum=128)
        bank = np.zeros((len(image_ids), cap, 128), np.float32)
        mask = np.zeros((len(image_ids), cap), bool)
        row_of = {i: r for r, i in enumerate(image_ids)}
        for i in image_ids:
            n = len(sub[i])
            bank[row_of[i], :n] = sub[i]
            mask[row_of[i], :n] = True
        bank_t = torch.from_numpy(bank).to(torch.bfloat16).to(self.device)
        mask_t = torch.from_numpy(mask).to(self.device)
        kept = []
        # The reference walks brute pairs in host batches of max_pairs_size
        # and filters each batch (FeatureMatching.cpp:110-142).
        B = _pad_pow2(self.cfg.max_pairs_size, minimum=64)
        for start in range(0, len(pairs), B):
            chunk = pairs[start : start + B]
            padded = chunk + [chunk[-1]] * (B - len(chunk))
            ids = [[row_of[a], row_of[b]] for a, b in padded]
            idx_b = match_pairs_batch(
                bank_t, mask_t, ids,
                ratio=cfg.distance_ratio, max_distance=2.0,
                cross_check=False, col_tile=cap,
            ).cpu().numpy()
            for p, (a, b) in enumerate(chunk):
                if (idx_b[p] >= 0).sum() >= cfg.preemptive_min_num_matches:
                    kept.append((a, b))
        log(f"[match] preemptive filter kept {len(kept)}/{len(pairs)} pairs")
        return kept


class SequentialFeatureMatcher(_MatcherBase):
    """Each image vs its `overlap` predecessors (video-style collections)."""

    def run_matching(self, database_path: str, log=print) -> int:
        db = Database(database_path)
        try:
            image_ids = sorted(db.read_all_images().keys())
            bank, mask, kps, _ = self._load_bank(db, image_ids)
            pairs = [
                (image_ids[i - k], image_ids[i])
                for i in range(len(image_ids))
                for k in range(1, self.cfg.overlap + 1)
                if i - k >= 0
            ]
            return self._match_and_verify_pairs(
                db, bank, mask, kps, image_ids, pairs, log
            )
        finally:
            db.close()


class BruteFeatureMatcher(_MatcherBase):
    """All pairs i < j, optional preemptive pruning."""

    def run_matching(self, database_path: str, log=print) -> int:
        db = Database(database_path)
        try:
            image_ids = sorted(db.read_all_images().keys())
            pairs = [
                (image_ids[i], image_ids[j])
                for i in range(len(image_ids))
                for j in range(i + 1, len(image_ids))
            ]
            if self.cfg.is_preemptive:
                pairs = self._preemptive_keep(db, image_ids, pairs, log)
            bank, mask, kps, _ = self._load_bank(db, image_ids)
            return self._match_and_verify_pairs(
                db, bank, mask, kps, image_ids, pairs, log
            )
        finally:
            db.close()
