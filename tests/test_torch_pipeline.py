"""The port's extract + match stages against the JAX package's, end to end.

Both packages run on the CPU from the same rendered PNGs into their own
SQLite databases; the database is the interface between stages, so the JAX
matcher is also run on the port's database.
"""

import shutil

import numpy as np
import pytest

from monocularsfm_torch.utils.png import write_png
from monocularsfm_torch.utils.synthetic import render_textured_images

MIN_VERIFIED = 15


def _verified(db_path):
    from monocularsfm_tpu.database import Database

    db = Database(db_path)
    try:
        return {p: len(m) for p, m in db.read_all_matches().items()}
    finally:
        db.close()


def _config(module, images, db_path):
    cfg = module.SfMConfig(images_path=str(images), database_path=str(db_path))
    if hasattr(cfg.parallel, "shard_matching"):
        cfg.parallel.shard_matching = False
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from monocularsfm_torch import cli as torch_cli, config as torch_config
    from monocularsfm_tpu import cli as jax_cli, config as jax_config

    root = tmp_path_factory.mktemp("pipeline")
    images = root / "images"
    images.mkdir()
    imgs = render_textured_images(num_cameras=4, width=320, height=240,
                                  arc_deg=30.0, scene_seed=5)[0]
    for i, im in enumerate(imgs):
        write_png(images / f"im{i:02d}.png", im)
    quiet = lambda *a: None  # noqa: E731

    jax_db = root / "jax.db"
    cfg = _config(jax_config, images, jax_db)
    jax_cli.cmd_extract(cfg, log=quiet)
    jax_cli.cmd_match(cfg, log=quiet)

    torch_db = root / "torch.db"
    cfg_t = _config(torch_config, images, torch_db)
    torch_cli.cmd_extract(cfg_t, device="cpu", log=quiet)
    torch_cli.cmd_match(cfg_t, device="cpu", log=quiet)
    counts = torch_cli.cmd_check_matches(cfg_t, log=quiet)

    # The JAX matcher on the port's features.
    cross_db = root / "cross.db"
    shutil.copy(torch_db, cross_db)
    from monocularsfm_tpu.database import Database

    db = Database(cross_db)
    db.conn.execute("DELETE FROM matches")
    db.close()
    jax_cli.cmd_match(_config(jax_config, images, cross_db), log=quiet)
    return (_verified(jax_db), _verified(torch_db), _verified(cross_db),
            counts)


def test_same_pairs_verified(runs):
    jax_m, torch_m, _, counts = runs
    assert set(jax_m) == set(torch_m) and len(jax_m) == 6
    good = lambda m: {p for p, n in m.items() if n >= MIN_VERIFIED}  # noqa: E731
    assert good(torch_m) == good(jax_m)
    # Neighbouring views along the arc always verify.
    assert {(1, 2), (2, 3), (3, 4)} <= good(torch_m)
    assert counts == torch_m


def test_per_pair_counts_within_ten_percent(runs):
    jax_m, torch_m, _, _ = runs
    for p, n in jax_m.items():
        assert abs(torch_m[p] - n) <= 0.1 * max(n, torch_m[p]), (p, n, torch_m[p])


def test_reference_matcher_reads_port_database(runs):
    _, torch_m, cross_m, _ = runs
    good = lambda m: {p for p, n in m.items() if n >= MIN_VERIFIED}  # noqa: E731
    assert good(cross_m) == good(torch_m)
    for p, n in torch_m.items():
        assert abs(cross_m[p] - n) <= 0.1 * max(n, cross_m[p]), (p, n, cross_m[p])
