"""Tests for dataset utilities and the demo CLI."""

import os

import numpy as np
import pytest

from akaze_jax.io import (FrameSequence, load_kitti_poses, save_kitti_poses,
                          ate_rmse, synthetic_sequence, save_pgm)


class TestSyntheticSequence:
    def test_shapes_and_offsets(self, rng):
        frames, offs = synthetic_sequence(rng, n_frames=5, size=(120, 160),
                                          shift_per_frame=(3.0, 1.0))
        assert frames.shape == (5, 120, 160)
        assert frames.dtype == np.uint8
        np.testing.assert_allclose(offs[1] - offs[0], [3, 1], atol=0.51)

    def test_frames_are_shifted_views(self, rng):
        frames, offs = synthetic_sequence(rng, n_frames=3, size=(100, 100),
                                          shift_per_frame=(0.0, 5.0))
        # frame k shifted by 5 px in x: overlapping region must agree
        a = frames[0][:, 5:]
        b = frames[1][:, :-5]
        assert np.mean(np.abs(a.astype(int) - b.astype(int))) < 1.0


class TestKittiPoses:
    def test_roundtrip(self, tmp_path, rng):
        R = np.tile(np.eye(3, dtype=np.float32), (4, 1, 1))
        t = rng.standard_normal((4, 3)).astype(np.float32)
        p = str(tmp_path / "poses.txt")
        save_kitti_poses(p, R, t)
        R2, t2 = load_kitti_poses(p)
        np.testing.assert_allclose(R2, R, atol=1e-6)
        np.testing.assert_allclose(t2, t, atol=1e-6)


class TestAte:
    def test_zero_for_identical(self, rng):
        t = rng.standard_normal((10, 3))
        assert ate_rmse(t, t) < 1e-9

    def test_alignment_removes_similarity(self, rng):
        t = rng.standard_normal((20, 3))
        ang = 0.3
        R = np.asarray([[np.cos(ang), -np.sin(ang), 0],
                        [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
        t2 = 1.7 * t @ R.T + np.asarray([5.0, -2.0, 1.0])
        assert ate_rmse(t2, t, align=True) < 1e-6
        assert ate_rmse(t2, t, align=False) > 1.0


class TestFrameSequence:
    def test_reads_in_order(self, tmp_path, rng):
        for i in range(4):
            save_pgm(str(tmp_path / f"{i:06d}.pgm"),
                     np.full((8, 10), i * 10, np.uint8))
        seq = FrameSequence(str(tmp_path))
        frames = list(seq)
        assert len(frames) == 4
        for i, f in enumerate(frames):
            assert f[0, 0] == i * 10

    def test_missing_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            FrameSequence(str(tmp_path / "none"))


class TestCli:
    def test_demo_runs(self, tmp_path, rng, capsys):
        from akaze_jax.cli import main
        frames, _ = synthetic_sequence(rng, n_frames=2, size=(160, 200),
                                       shift_per_frame=(2.0, 3.0))
        lp = str(tmp_path / "l.pgm")
        rp = str(tmp_path / "r.pgm")
        save_pgm(lp, frames[0])
        save_pgm(rp, frames[1])
        main(["--left", lp, "--right", rp, "--iters", "1",
              "--max-pts", "512", "--out-dir", str(tmp_path), "--json"])
        out = capsys.readouterr().out.strip().splitlines()[-1]
        import json
        rec = json.loads(out)
        assert rec["left_pts"] > 5
        assert rec["matches"] > 3
        assert os.path.exists(str(tmp_path / "akaze_keypoints.png"))
        assert os.path.exists(str(tmp_path / "akaze_matches.png"))

    def test_demo_spatial_mode(self, tmp_path, rng, capsys):
        """--spatial N runs the row-sharded front-end over an N-device
        mesh (the oversized-image path) through the same demo lifecycle."""
        import jax
        if len(jax.devices()) < 2:
            pytest.skip("needs 2 (virtual) devices")
        from akaze_jax.cli import main
        frames, _ = synthetic_sequence(rng, n_frames=2, size=(160, 200),
                                       shift_per_frame=(2.0, 3.0))
        lp = str(tmp_path / "l.pgm")
        rp = str(tmp_path / "r.pgm")
        save_pgm(lp, frames[0])
        save_pgm(rp, frames[1])
        main(["--left", lp, "--right", rp, "--iters", "1",
              "--max-pts", "512", "--out-dir", str(tmp_path), "--json",
              "--spatial", "2"])
        out = capsys.readouterr().out.strip().splitlines()[-1]
        import json
        rec = json.loads(out)
        assert rec["left_pts"] > 5
        assert rec["matches"] > 3


class TestKittiEval:
    @pytest.mark.slow
    def test_kitti_layout_end_to_end(self, tmp_path, rng):
        """benchmarks/odometry_eval.py --kitti-dir consumes a KITTI-layout
        directory (image_0/*.pgm + poses.txt + calib.txt) end to end."""
        import json
        import sys
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                        "benchmarks"))
        import odometry_eval

        img_dir = tmp_path / "image_0"
        img_dir.mkdir()
        frames, offs = synthetic_sequence(rng, n_frames=5, size=(192, 256),
                                          shift_per_frame=(3.0, 1.5),
                                          n_blobs=80)
        for i, f in enumerate(frames):
            save_pgm(str(img_dir / f"{i:06d}.pgm"), f)
        R = np.tile(np.eye(3, dtype=np.float32), (5, 1, 1))
        t = np.concatenate([np.asarray(offs, np.float32) * 0.01,
                            np.zeros((5, 1), np.float32)], axis=1)
        save_kitti_poses(str(tmp_path / "poses.txt"), R, t)
        with open(tmp_path / "calib.txt", "w") as f:
            f.write("P0: 230.0 0.0 128.0 0.0 0.0 230.0 96.0 0.0 "
                    "0.0 0.0 1.0 0.0\n")

        rec = odometry_eval.run_kitti(str(tmp_path), max_frames=5)
        assert rec["frames"] == 5
        assert np.isfinite(rec["ate"])
        assert rec["keyframes"] >= 1
        # intrinsics parsed from calib.txt
        fx, fy, cx, cy = odometry_eval.load_kitti_intrinsics(
            str(tmp_path), frames[0].shape)
        assert (fx, fy, cx, cy) == (230.0, 230.0, 128.0, 96.0)


class TestDebugPlanes:
    def test_debug_planes_and_dump(self, tmp_path, test_image):
        from akaze_jax import AkazeConfig
        from akaze_jax.plan import build_plan
        from akaze_jax.debug import debug_planes, dump_planes
        cfg = AkazeConfig(max_pts=128, noctaves=2)
        plan = build_plan(*test_image.shape, cfg)
        planes = debug_planes(test_image, plan)
        assert "L0_0" in planes and "det1_3" in planes
        assert planes["response_map"].shape == test_image.shape
        assert planes["nms_mask"].dtype == bool
        dump_planes({"L0_0": planes["L0_0"],
                     "nms_mask": planes["nms_mask"].astype(np.float32)},
                    str(tmp_path))
        assert (tmp_path / "L0_0.png").exists()
