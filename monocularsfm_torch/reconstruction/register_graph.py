"""Registration scheduler: which image to try next.

Reference parity: src/Reconstruction/RegisterGraph.cpp — adjacency +
registered flags + per-image trial counts + registered-neighbor counts
(RegisterGraph.h:44-50); GetNextImageIds returns two buckets — never-tried
images first, then already-tried ones — each sorted by number of registered
neighbors descending (:75-139); SetRegistered bumps neighbor counts (:34-44).

Pure host logic (inherently sequential control flow), kept as plain Python.
"""

from __future__ import annotations

import collections


class RegisterGraph:
    def __init__(self, max_trials: int = 3):
        self.adj: dict[int, set[int]] = collections.defaultdict(set)
        self.registered: dict[int, bool] = {}
        self.trials: dict[int, int] = {}
        self.num_registered_neighbor: dict[int, int] = {}
        self.max_trials = max_trials

    def add_edge(self, id1: int, id2: int):
        self.adj[id1].add(id2)
        self.adj[id2].add(id1)
        for i in (id1, id2):
            self.registered.setdefault(i, False)
            self.trials.setdefault(i, 0)
            self.num_registered_neighbor.setdefault(i, 0)

    @classmethod
    def from_edges(cls, pair_matches: dict[tuple[int, int], int], max_trials: int = 3):
        g = cls(max_trials=max_trials)
        for (i, j) in pair_matches:
            g.add_edge(i, j)
        return g

    def set_registered(self, image_id: int):
        if self.registered.get(image_id):
            return
        self.registered[image_id] = True
        for nb in self.adj[image_id]:
            self.num_registered_neighbor[nb] += 1

    def add_trial(self, image_id: int):
        self.trials[image_id] = self.trials.get(image_id, 0) + 1

    def num_registered(self) -> int:
        return sum(self.registered.values())

    def mean_trials(self) -> float:
        tried = [t for t in self.trials.values() if t > 0]
        return sum(tried) / len(tried) if tried else 0.0

    def get_next_image_ids(self) -> list[int]:
        """Candidates ordered: fresh bucket (0 trials) before retry bucket,
        each sorted by registered-neighbor count descending; images that
        exhausted max_trials are dropped (reference retries from the 'bad
        bucket' with a trial budget, RegisterGraph.cpp:100-108)."""
        fresh, retry = [], []
        for i, reg in self.registered.items():
            if reg or self.num_registered_neighbor[i] == 0:
                continue
            t = self.trials[i]
            if t == 0:
                fresh.append(i)
            elif t < self.max_trials:
                retry.append(i)
        keyfn = lambda i: (-self.num_registered_neighbor[i], i)
        return sorted(fresh, key=keyfn) + sorted(retry, key=keyfn)
