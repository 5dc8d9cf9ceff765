"""SQLite feature/match store — reference-schema-compatible.

Reference parity: src/Database/Database.cpp —
  tables images(image_id, name) / keypoints / keypoints_colors / descriptors
  (image_id, rows, cols, data BLOB) / matches(pair_id, rows, cols, data)
  created at :701-764; WAL + synchronous=OFF pragmas :299-302; pair-id packing
  pair_id = 10000*min + max with kMaxNumImages=10000 (:6, :656-694); Blob<T>
  row-major POD serialisation (:41-88); idempotent-resume via Exist* checks.

Using the stdlib sqlite3 here matches the reference exactly in spirit — the
reference simply embeds stock SQLite (ext/SQLite/) — while staying entirely on
the host side; nothing in this module is ever traced by JAX.  Keeping the
byte-identical schema preserves the reference's two key properties: the DB
file is the only interface between pipeline stages, and any stage can be
killed and re-run idempotently.
"""

from __future__ import annotations

import pathlib
import sqlite3

import numpy as np

from monocularsfm_torch.types import (
    image_pair_to_pair_id,
    pair_id_to_image_pair,
)

# dtype tags matching the reference Blob<T> payloads:
#   keypoints: float32 (x, y, scale, orientation) x N      [ref stores cv::KeyPoint
#     fields as 4 floats per row via Blob<float>, Database.cpp:41-88 usage]
#   colors: uint8 (b, g, r) x N
#   descriptors: float32 N x 128
#   matches: int32 N x 2
_KEYPOINT_COLS = 4


class Database:
    """Typed read/write/exist/num accessors over the 5 reference tables."""

    def __init__(self, path: str | pathlib.Path):
        self.path = str(path)
        # isolation_level=None -> autocommit with *explicit* BEGIN/COMMIT under
        # our control, like the reference's Begin/EndTransaction pair; the
        # default python mode auto-opens transactions and then explicit BEGIN
        # raises "cannot start a transaction within a transaction".
        self.conn = sqlite3.connect(self.path, isolation_level=None)
        self.conn.execute("PRAGMA journal_mode=WAL")
        self.conn.execute("PRAGMA synchronous=OFF")
        self._create_tables()

    # -- lifecycle ---------------------------------------------------------
    def close(self):
        self.conn.commit()
        self.conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def begin_transaction(self):
        self.conn.execute("BEGIN")

    def end_transaction(self):
        self.conn.commit()

    def _create_tables(self):
        cur = self.conn.cursor()
        cur.execute(
            "CREATE TABLE IF NOT EXISTS images ("
            " image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,"
            " name TEXT NOT NULL UNIQUE)"
        )
        for table in ("keypoints", "keypoints_colors", "descriptors"):
            cur.execute(
                f"CREATE TABLE IF NOT EXISTS {table} ("
                " image_id INTEGER PRIMARY KEY NOT NULL,"
                " rows INTEGER NOT NULL, cols INTEGER NOT NULL,"
                " data BLOB,"
                " FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE)"
            )
        cur.execute(
            "CREATE TABLE IF NOT EXISTS matches ("
            " pair_id INTEGER PRIMARY KEY NOT NULL,"
            " rows INTEGER NOT NULL, cols INTEGER NOT NULL,"
            " data BLOB)"
        )
        self.conn.commit()

    # -- images ------------------------------------------------------------
    def write_image(self, name: str) -> int:
        cur = self.conn.execute("INSERT INTO images(name) VALUES (?)", (name,))
        return int(cur.lastrowid)

    def exist_image(self, name: str) -> bool:
        r = self.conn.execute("SELECT 1 FROM images WHERE name=?", (name,)).fetchone()
        return r is not None

    def read_image_id(self, name: str) -> int:
        r = self.conn.execute("SELECT image_id FROM images WHERE name=?", (name,)).fetchone()
        if r is None:
            raise KeyError(name)
        return int(r[0])

    def read_image_name(self, image_id: int) -> str:
        r = self.conn.execute(
            "SELECT name FROM images WHERE image_id=?", (image_id,)
        ).fetchone()
        if r is None:
            raise KeyError(image_id)
        return r[0]

    def read_all_images(self) -> dict[int, str]:
        return {
            int(i): n for i, n in self.conn.execute("SELECT image_id, name FROM images")
        }

    def num_images(self) -> int:
        return int(self.conn.execute("SELECT COUNT(*) FROM images").fetchone()[0])

    # -- blobs -------------------------------------------------------------
    def _write_blob(self, table: str, key_col: str, key: int, arr: np.ndarray):
        arr = np.ascontiguousarray(arr)
        rows, cols = (arr.shape + (1, 1))[:2] if arr.ndim >= 2 else (arr.shape[0], 1)
        self.conn.execute(
            f"INSERT OR REPLACE INTO {table}({key_col}, rows, cols, data) VALUES (?,?,?,?)",
            (int(key), int(rows), int(cols), arr.tobytes()),
        )

    def _read_blob(self, table: str, key_col: str, key: int, dtype) -> np.ndarray | None:
        r = self.conn.execute(
            f"SELECT rows, cols, data FROM {table} WHERE {key_col}=?", (int(key),)
        ).fetchone()
        if r is None:
            return None
        rows, cols, data = r
        return np.frombuffer(data, dtype=dtype).reshape(rows, cols).copy()

    def _exist(self, table: str, key_col: str, key: int) -> bool:
        r = self.conn.execute(
            f"SELECT 1 FROM {table} WHERE {key_col}=?", (int(key),)
        ).fetchone()
        return r is not None

    # -- keypoints / colors / descriptors -----------------------------------
    def write_keypoints(self, image_id: int, keypoints: np.ndarray):
        """keypoints: (N, 4) float32 — x, y, scale, orientation."""
        assert keypoints.ndim == 2 and keypoints.shape[1] == _KEYPOINT_COLS
        self._write_blob("keypoints", "image_id", image_id, keypoints.astype(np.float32))

    def read_keypoints(self, image_id: int) -> np.ndarray | None:
        return self._read_blob("keypoints", "image_id", image_id, np.float32)

    def exist_keypoints(self, image_id: int) -> bool:
        return self._exist("keypoints", "image_id", image_id)

    def write_keypoints_color(self, image_id: int, colors: np.ndarray):
        """colors: (N, 3) uint8 BGR (reference samples cv::Mat pixels)."""
        self._write_blob("keypoints_colors", "image_id", image_id, colors.astype(np.uint8))

    def read_keypoints_color(self, image_id: int) -> np.ndarray | None:
        return self._read_blob("keypoints_colors", "image_id", image_id, np.uint8)

    def write_descriptors(self, image_id: int, descriptors: np.ndarray):
        """descriptors: (N, 128) float32, normalised per extraction config."""
        self._write_blob("descriptors", "image_id", image_id, descriptors.astype(np.float32))

    def read_descriptors(self, image_id: int) -> np.ndarray | None:
        return self._read_blob("descriptors", "image_id", image_id, np.float32)

    def exist_descriptors(self, image_id: int) -> bool:
        return self._exist("descriptors", "image_id", image_id)

    # -- matches -------------------------------------------------------------
    def write_matches(self, image_id1: int, image_id2: int, matches: np.ndarray):
        """matches: (N, 2) int32 indices into (image_id1, image_id2) keypoints.

        Stored under the packed unordered pair id; columns are swapped when
        image_id1 > image_id2, exactly like the reference (Database.cpp:656-694).
        """
        matches = np.asarray(matches, dtype=np.int32).reshape(-1, 2)
        if image_id1 > image_id2:
            matches = matches[:, ::-1]
        pair_id = image_pair_to_pair_id(image_id1, image_id2)
        self._write_blob("matches", "pair_id", pair_id, matches)

    def read_matches(self, image_id1: int, image_id2: int) -> np.ndarray | None:
        pair_id = image_pair_to_pair_id(image_id1, image_id2)
        m = self._read_blob("matches", "pair_id", pair_id, np.int32)
        if m is None:
            return None
        if image_id1 > image_id2:
            m = m[:, ::-1].copy()
        return m

    def exist_matches(self, image_id1: int, image_id2: int) -> bool:
        return self._exist("matches", "pair_id", image_pair_to_pair_id(image_id1, image_id2))

    def read_all_matches(self) -> dict[tuple[int, int], np.ndarray]:
        """All verified matches keyed by (smaller_id, larger_id)."""
        out = {}
        for pair_id, rows, cols, data in self.conn.execute(
            "SELECT pair_id, rows, cols, data FROM matches"
        ):
            m = np.frombuffer(data, dtype=np.int32).reshape(rows, cols).copy()
            out[pair_id_to_image_pair(pair_id)] = m
        return out

    def num_matches(self) -> int:
        return int(self.conn.execute("SELECT COUNT(*) FROM matches").fetchone()[0])
