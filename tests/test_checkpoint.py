"""Tests for checkpoint/resume."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from akaze_jax.slam.checkpoint import (save_checkpoint, load_checkpoint,
                                       latest_step)


def test_roundtrip_pytree(tmp_path, rng):
    state = {"R": jnp.asarray(rng.standard_normal((5, 3, 3)),
                              jnp.float32),
             "t": jnp.asarray(rng.standard_normal((5, 3)), jnp.float32),
             "ids": jnp.arange(7, dtype=jnp.int32)}
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, state, metadata={"step": 42})
    loaded, meta = load_checkpoint(p, like=state)
    assert meta["step"] == 42
    for k in state:
        np.testing.assert_array_equal(np.asarray(loaded[k]),
                                      np.asarray(state[k]))


def test_directory_rotation(tmp_path):
    d = str(tmp_path / "ckpts")
    for step in range(5):
        save_checkpoint(d, {"x": jnp.full(3, step)}, keep=3)
    files = sorted(os.listdir(d))
    assert len(files) == 3
    assert latest_step(d) == 4
    (loaded,), meta = load_checkpoint(d, like=None)[0], {}
    state, meta = load_checkpoint(d, like={"x": jnp.zeros(3)})
    np.testing.assert_array_equal(np.asarray(state["x"]), [4, 4, 4])


def test_structure_mismatch_raises(tmp_path):
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, {"a": jnp.zeros(2), "b": jnp.zeros(3)})
    with pytest.raises(ValueError):
        load_checkpoint(p, like={"a": jnp.zeros(2)})


def test_missing_directory(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path))
    assert latest_step(str(tmp_path / "nope")) == -1


def test_old_format_poses_checkpoint_restorable(tmp_path):
    """Pre-full-map checkpoints ({R, t, frame_idx}, no state_keys) must
    still key correctly through SlamSystem's format shim, and the full
    restore must reject them with a clear error instead of a KeyError."""
    from akaze_jax.slam.system import SlamSystem

    p = str(tmp_path / "old.npz")
    R = np.stack([np.eye(3, dtype=np.float32)] * 2)
    t = np.asarray([[0, 0, 0], [1, 0, 0]], np.float32)
    fi = np.asarray([0, 3], np.int32)
    save_checkpoint(p, {"R": R, "t": t, "frame_idx": fi},
                    metadata={"n_edges": 0, "edges": []})

    leaves, meta = load_checkpoint(p)
    state = SlamSystem._checkpoint_state(leaves, meta)
    np.testing.assert_array_equal(state["kf_R"], R)
    np.testing.assert_array_equal(state["kf_t"], t)
    np.testing.assert_array_equal(state["kf_frame_idx"], fi)

    sys_ = SlamSystem.__new__(SlamSystem)  # format check needs no state
    with pytest.raises(ValueError, match="poses only"):
        sys_.restore(p)
