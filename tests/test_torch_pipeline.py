"""The port's stages against the JAX package's, end to end.

Both packages run on the CPU from the same rendered PNGs into their own
SQLite databases; the database is the interface between stages, so the JAX
matcher is also run on the port's database.  The port's reconstruct stage
runs on the port's database and the JAX package reads its COLMAP export.
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
    imgs, K, R, t = render_textured_images(num_cameras=4, width=320, height=240,
                                           arc_deg=30.0, scene_seed=5)
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
            counts, cfg_t, root, (K, R, t))


def test_same_pairs_verified(runs):
    jax_m, torch_m, _, counts = runs[:4]
    assert set(jax_m) == set(torch_m) and len(jax_m) == 6
    good = lambda m: {p for p, n in m.items() if n >= MIN_VERIFIED}  # noqa: E731
    assert good(torch_m) == good(jax_m)
    # Neighbouring views along the arc always verify.
    assert {(1, 2), (2, 3), (3, 4)} <= good(torch_m)
    assert counts == torch_m


def test_per_pair_counts_within_ten_percent(runs):
    jax_m, torch_m = runs[:2]
    for p, n in jax_m.items():
        assert abs(torch_m[p] - n) <= 0.1 * max(n, torch_m[p]), (p, n, torch_m[p])


def test_reference_matcher_reads_port_database(runs):
    _, torch_m, cross_m = runs[:3]
    good = lambda m: {p for p, n in m.items() if n >= MIN_VERIFIED}  # noqa: E731
    assert good(cross_m) == good(torch_m)
    for p, n in torch_m.items():
        assert abs(cross_m[p] - n) <= 0.1 * max(n, cross_m[p]), (p, n, cross_m[p])


def test_reconstruct_on_port_database_is_read_by_reference(runs):
    from monocularsfm_torch import cli as torch_cli
    from monocularsfm_tpu.io.colmap import read_colmap
    from monocularsfm_tpu.io.openmvs import read_openmvs_summary

    cfg, root, (K, R, t) = runs[4], runs[5], runs[6]
    cfg.output_path = str(root / "torch_out")
    cfg.camera.fx, cfg.camera.fy = K[0, 0], K[1, 1]
    cfg.camera.cx, cfg.camera.cy = K[0, 2], K[1, 2]
    cfg.initializer.init_min_num_inliers = 50     # 320x240 views, few matches
    builder = torch_cli.cmd_reconstruct(cfg, device="cpu", log=lambda *a: None)
    st = builder.map.statistics()
    assert st.num_registered_images >= 3 and st.num_points3D > 50
    assert st.mean_reprojection_error < 1.0
    model = read_colmap(root / "torch_out" / "colmap")
    assert sorted(model["images"]) == sorted(builder.map.registered_ids)
    assert len(model["points"]) == st.num_points3D
    for i, im in model["images"].items():
        np.testing.assert_allclose(im["R"], builder.map.images[i].R, atol=1e-5)
    mvs = read_openmvs_summary(root / "torch_out" / "scene.mvs")
    assert mvs["images"] == 4 and mvs["posed_images"] == st.num_registered_images
    assert len(list((root / "torch_out" / "undistorted_images").glob("*.png"))) == 4
    for name in ("cloud.ply", "cloud_binary.ply"):
        assert (root / "torch_out" / name).stat().st_size > 0


@pytest.mark.parametrize("command", ["reconstruct", "pipeline"])
def test_cli_runs_on_cpu(runs, tmp_path, command):
    """`sfm-torch reconstruct|pipeline cfg.yaml --device cpu`: reconstruct on
    a copy of the port's database, pipeline from the PNGs into a new one."""
    from monocularsfm_torch import cli as torch_cli
    from monocularsfm_tpu.io.colmap import read_colmap

    cfg, (K, _, _) = runs[4], runs[6]
    db = tmp_path / "cli.db"
    if command == "reconstruct":
        shutil.copy(cfg.database_path, db)
    out = tmp_path / "out"
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(
        f"images_path: {cfg.images_path}\n"
        f"database_path: {db}\n"
        f"output_path: {out}\n"
        f"camera: {{fx: {K[0, 0]}, fy: {K[1, 1]}, cx: {K[0, 2]}, cy: {K[1, 2]}}}\n"
        f"initializer: {{init_min_num_inliers: 50}}\n")
    assert torch_cli.main([command, str(cfg_path), "--device", "cpu"]) == 0
    model = read_colmap(out / "colmap")
    assert len(model["images"]) >= 3 and len(model["points"]) > 50
    for name in ("cloud.ply", "cloud_binary.ply", "scene.mvs"):
        assert (out / name).stat().st_size > 0


def test_cli_refuses_cuda_without_a_card(runs, tmp_path):
    import torch

    from monocularsfm_torch import cli as torch_cli

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible here")
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(f"images_path: {runs[4].images_path}\n"
                        f"database_path: {tmp_path / 'x.db'}\n")
    for cmd in ("reconstruct", "pipeline"):
        with pytest.raises(RuntimeError, match="cuda"):
            torch_cli.main([cmd, str(cfg_path)])


def test_reconstruction_agrees_with_reference_on_the_same_database(runs, tmp_path):
    """Both packages' `cmd_reconstruct` on copies of the port's database
    (the same features and verified matches), the port with the JAX
    package's RANSAC draws: the same registered images, point counts within
    5% and mean reprojection errors within 0.05 px of each other (measured:
    4 of 4 registered on both, 625 points each, 0.0579857 against
    0.0579862 px)."""
    from monocularsfm_torch import cli as torch_cli, config as torch_config
    from monocularsfm_tpu import cli as jax_cli, config as jax_config
    from test_torch_reconstruction import patch_engine_draws

    cfg_t, (K, _, _) = runs[4], runs[6]
    quiet = lambda *a: None  # noqa: E731
    builders = {}
    for name, module in (("jax", jax_config), ("torch", torch_config)):
        db = tmp_path / f"{name}.db"
        shutil.copy(cfg_t.database_path, db)
        cfg = _config(module, cfg_t.images_path, db)
        cfg.output_path = str(tmp_path / f"{name}_out")
        cfg.camera.fx, cfg.camera.fy = K[0, 0], K[1, 1]
        cfg.camera.cx, cfg.camera.cy = K[0, 2], K[1, 2]
        cfg.initializer.init_min_num_inliers = 50
        if name == "jax":
            builders[name] = jax_cli.cmd_reconstruct(cfg, log=quiet)
            continue
        with pytest.MonkeyPatch.context() as mp:
            patch_engine_draws(mp)
            builders[name] = torch_cli.cmd_reconstruct(cfg, device="cpu", log=quiet)
    mj, mt = builders["jax"].map, builders["torch"].map
    sj, st = mj.statistics(), mt.statistics()
    assert sorted(mt.registered_ids) == sorted(mj.registered_ids)
    assert len(mt.registered_ids) >= 3
    assert abs(st.num_points3D - sj.num_points3D) <= 0.05 * sj.num_points3D
    assert abs(st.mean_reprojection_error - sj.mean_reprojection_error) <= 0.05
