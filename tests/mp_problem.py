"""Deterministic BA problem shared by the multi-process parity test's
parent (test_multiprocess.py) and workers (mp_worker.py)."""

import numpy as np


def make_problem(n_cams: int = 5, n_pts: int = 48):
    import jax.numpy as jnp
    from akaze_jax.geometry import se3_exp, se3_inverse
    from akaze_jax.slam.ba import BAProblem

    rng = np.random.default_rng(1234)
    X = rng.uniform([-2, -2, 6], [2, 2, 12], (n_pts, 3)).astype(np.float32)
    Rs, ts = [], []
    for c in range(n_cams):
        xi = np.zeros(6, np.float32)
        xi[0] = 0.4 * c
        xi[4] = 0.03 * c
        R, t = se3_exp(jnp.asarray(xi))
        Ri, ti = se3_inverse(R, t)
        Rs.append(np.asarray(Ri))
        ts.append(np.asarray(ti))
    R = np.stack(Rs)
    t = np.stack(ts)

    cams, pts, uvs = [], [], []
    for c in range(n_cams):
        Xc = X @ R[c].T + t[c]
        uv = Xc[:, :2] / Xc[:, 2:3]
        for p in range(n_pts):
            if Xc[p, 2] > 0.5 and abs(uv[p, 0]) < 1 and abs(uv[p, 1]) < 1:
                cams.append(c)
                pts.append(p)
                uvs.append(uv[p])
    prob = BAProblem(cam=jnp.asarray(cams, jnp.int32),
                     pt=jnp.asarray(pts, jnp.int32),
                     uv=jnp.asarray(np.asarray(uvs, np.float32)),
                     w=jnp.ones(len(cams), jnp.float32))
    X0 = X + rng.standard_normal(X.shape).astype(np.float32) * 0.04
    return jnp.asarray(R), jnp.asarray(t), jnp.asarray(X0), prob


def make_frames(h: int = 96, w: int = 128, batch: int = 8):
    """Deterministic structured frame-pair batch shared by the parent and
    worker processes of the multi-process FRONT-END parity test: blobby
    images (keypoint-rich) with small per-frame shifts."""
    rng = np.random.default_rng(77)
    hh, ww = h + 16, w + 16
    yy, xx = np.mgrid[0:hh, 0:ww].astype(np.float64)
    img = np.zeros((hh, ww))
    for (cy, cx), s, a in zip(
            np.stack([rng.uniform(10, hh - 10, 30),
                      rng.uniform(10, ww - 10, 30)], -1),
            rng.uniform(2, 7, 30), rng.uniform(0.3, 1.0, 30)):
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    img += 0.05 * rng.standard_normal((hh, ww))
    img = np.clip(img, 0, 1).astype(np.float32)
    a = np.stack([img[i:i + h, i:i + w] for i in range(batch)])
    b = np.stack([img[i + 3:i + 3 + h, i + 5:i + 5 + w]
                  for i in range(batch)])
    return a, b


def make_big_image(h: int = 256, w: int = 320):
    """Deterministic blobby image for the multi-process SPATIAL (row-
    sharded) front-end parity leg: the halo exchange between devices 3|4
    crosses the host/gloo boundary."""
    rng = np.random.default_rng(55)
    base = rng.random((h // 8, w // 8)).astype(np.float32)
    img = np.kron(base, np.ones((8, 8), np.float32))
    img += 0.05 * rng.random((h, w)).astype(np.float32)
    return np.clip(img, 0, 1).astype(np.float32)
