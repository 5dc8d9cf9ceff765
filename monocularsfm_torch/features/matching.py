"""Matching stage: pair scheduling on host, batched matching on the device.

The port of monocularsfm_tpu/features/matching.py (reference parity:
src/Feature/FeatureMatching.cpp — skip-if-exists -> cross/ratio match ->
distance filter -> F-RANSAC verification -> WriteMatches :10-73; sequential
:75-100; brute with the optional VisualSFM preemptive filter :102-178).
Descriptors live in a device-resident bf16 bank; the host decides which
pairs to run (sequential, brute, or retrieved through a visual vocabulary),
each batch of pairs is one `match_pairs_batch` call (kernel 3 on the card),
and geometric verification is hypothesis-parallel F-RANSAC whose uniform
draws come from the matcher's own torch.Generator.  The "opencv" backend is
the reference's own per-pair cv2 loop on an f32 host bank (cv2 is imported
only when that backend runs).
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
        if self.cfg.backend not in ("jax", "opencv"):
            raise ValueError(f"unknown matching backend {self.cfg.backend!r}")
        self.device = torch.device(device)
        self._gen = torch.Generator(self.device).manual_seed(1234)

    # -- descriptor bank -----------------------------------------------------
    @staticmethod
    def _host_bank(db: Database, image_ids: list[int]):
        """(I, cap, 128) f32 bank and (I, cap) mask on the host, as read from
        the database, + keypoints."""
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
        return bank, mask, kps, cap

    def _upload(self, bank: np.ndarray, mask: np.ndarray):
        """The matcher's bank.  The device path takes a device-resident bf16
        bank: the matcher rounds descriptors to bf16 before its product
        anyway, so it is output-preserving and halves the upload.  The cv2
        backend keeps the f32 host bank (cv2 only takes CV_32F)."""
        if self.cfg.backend == "opencv":
            return bank, mask
        return (torch.from_numpy(bank).to(torch.bfloat16).to(self.device),
                torch.from_numpy(mask).to(self.device))

    def _load_bank(self, db: Database, image_ids: list[int]):
        bank, mask, kps, cap = self._host_bank(db, image_ids)
        return (*self._upload(bank, mask), kps, cap)

    # -- geometric verification ---------------------------------------------
    def _draw(self, shape) -> torch.Tensor:
        """One F-RANSAC round's uniform draws, (pairs, hypotheses,
        candidates): the one place the matcher makes them."""
        return torch.rand(shape, generator=self._gen, device=self.device)

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
            u = self._draw((Bc, M, cap))
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

    # -- OpenCV CPU backend (the reference's exact match path) ---------------
    def _match_and_verify_pairs_cv2(self, db, bank, mask, kps, image_ids,
                                    pairs, log=print) -> int:
        """Per-pair cv2 BFMatcher knn2 + ratio + cross-check + distance
        filter + cv2.findFundamentalMat, the reference's CPU matching loop
        (FeatureUtils.cpp:141-206, FeatureMatching.cpp:10-73), on the f32
        host bank.  findFundamentalMat draws from cv2's global RNG
        (cv2.setRNGSeed fixes it)."""
        import cv2

        row_of = {i: r for r, i in enumerate(image_ids)}
        cfg = self.cfg
        matcher = cv2.BFMatcher(cv2.NORM_L2)
        written = 0
        for a, b in pairs:
            if db.exist_matches(a, b):
                continue
            d1 = bank[row_of[a]][mask[row_of[a]]]
            d2 = bank[row_of[b]][mask[row_of[b]]]

            def ratio_matches(da, db_):
                out = {}
                if len(da) < 2 or len(db_) < 2:
                    return out
                for m in matcher.knnMatch(da, db_, k=2):
                    if len(m) == 2 and m[0].distance < \
                            cfg.distance_ratio * m[1].distance:
                        out[m[0].queryIdx] = (m[0].trainIdx, m[0].distance)
                return out

            m12 = ratio_matches(d1, d2)
            m21 = ratio_matches(d2, d1)
            # CrossCheck (FeatureUtils.cpp:281-310) + distance filter.
            if cfg.cross_check:
                keep = [
                    (q, t, dd) for q, (t, dd) in m12.items()
                    if m21.get(t, (-1, 0))[0] == q
                ]
            else:
                keep = [(q, t, dd) for q, (t, dd) in m12.items()]
            keep = [(q, t) for q, t, dd in keep if dd <= cfg.max_distance]
            if len(keep) < cfg.min_num_matches_verified:
                db.write_matches(a, b, np.zeros((0, 2), np.int32))
                continue
            i_idx = np.asarray([q for q, _ in keep], np.int32)
            j_idx = np.asarray([t for _, t in keep], np.int32)
            pts1 = kps[a][i_idx, :2].astype(np.float32)
            pts2 = kps[b][j_idx, :2].astype(np.float32)
            _, inl = cv2.findFundamentalMat(
                pts1, pts2, cv2.FM_RANSAC, cfg.ransac_threshold_px,
                cfg.ransac_confidence)
            if inl is None:
                inl = np.zeros(len(pts1), np.uint8)
            inl = inl.ravel().astype(bool)
            m = np.stack([i_idx[inl], j_idx[inl]], axis=1).astype(np.int32)
            if len(m) < cfg.min_num_matches_verified:
                m = np.zeros((0, 2), np.int32)
            db.write_matches(a, b, m)
            written += 1
            log(f"[match] ({a},{b}): {len(i_idx)} raw -> {len(m)} verified")
        return written

    # -- one batched call over a pair slab ------------------------------------
    def _match_and_verify_pairs(self, db, bank, mask, kps, image_ids, pairs,
                                log=print) -> int:
        """pairs: list of (image_id_a, image_id_b). Returns #pairs written."""
        if self.cfg.backend == "opencv":
            return self._match_and_verify_pairs_cv2(
                db, bank, mask, kps, image_ids, pairs, log)
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


class VocabTreeFeatureMatcher(_MatcherBase):
    """Retrieval-based matching via a visual vocabulary (ops/vocab.py).

    The reference declares this matcher but never implements it
    (include/Feature/FeatureMatching.h:137-141).  Train a K-word vocabulary
    on the collection's own descriptors, build TF-IDF image signatures,
    retrieve `vocab_num_neighbors` partners per image with one similarity
    product, and feed those pairs through the standard match-and-verify
    path: O(I * num_neighbors) pairs instead of O(I^2).  The vocabulary is
    trained, and the images quantized, on the f32 descriptors as read from
    the database (a bf16 bank cast back would not recover the lost bits);
    the matcher keeps its bf16 bank."""

    def run_matching(self, database_path: str, log=print) -> int:
        from monocularsfm_torch.ops.vocab import (
            quantize_batch, retrieve_top_k, tfidf_signatures,
            train_visual_vocab,
        )

        cfg = self.cfg
        db = Database(database_path)
        try:
            image_ids = sorted(db.read_all_images().keys())
            host, hmask, kps, _ = self._host_bank(db, image_ids)
            n_desc = int(hmask.sum())
            num_words = min(cfg.vocab_num_words, max(64, n_desc // 2))
            flat = host[hmask]
            log(f"[match] training {num_words}-word vocab on {len(flat)} descriptors")
            vocab = train_visual_vocab(flat, num_words=num_words, device=self.device)
            hists = quantize_batch(torch.from_numpy(host).to(self.device),
                                   torch.from_numpy(hmask).to(self.device),
                                   vocab, num_words)
            k = min(cfg.vocab_num_neighbors, len(image_ids) - 1)
            _, nbrs = retrieve_top_k(tfidf_signatures(hists), k)
            nbrs = nbrs.cpu().numpy()
            pairs = sorted({
                (min(image_ids[i], image_ids[int(j)]),
                 max(image_ids[i], image_ids[int(j)]))
                for i in range(len(image_ids)) for j in nbrs[i]
            })
            log(f"[match] retrieval kept {len(pairs)} pairs "
                f"(exhaustive would be {len(image_ids)*(len(image_ids)-1)//2})")
            bank, mask = self._upload(host, hmask)
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
