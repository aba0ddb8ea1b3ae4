"""Synthetic long-sequence SLAM scenes (ring corridor + pillars), numpy only.

A copy of gtsam_points_tpu/utils/synthetic.py (same seeds, same numbers): a
structured world of two cylinder walls, a floor and pillars, a circular
trajectory, and per-pose scans of the nearest world points with measurement
noise. The port keeps its own copy so that it imports nothing of the JAX
package.
"""

from __future__ import annotations

import numpy as np


def ring_world(seed: int = 0, n: int = 24000) -> np.ndarray:
    """[n, 3] points: cylinder walls r=18 and r=26, floor, 80 pillars."""
    rng = np.random.RandomState(seed)
    quarter = n // 4
    out = []
    for r in (18.0, 26.0):
        th = rng.rand(quarter).astype(np.float32) * 2 * np.pi
        z = rng.rand(quarter).astype(np.float32) * 4.0
        rr = r + rng.randn(quarter).astype(np.float32) * 0.03
        out.append(np.stack([rr * np.cos(th), rr * np.sin(th), z], axis=1))
    th = rng.rand(quarter).astype(np.float32) * 2 * np.pi
    rr = 18.0 + rng.rand(quarter).astype(np.float32) * 8.0
    out.append(
        np.stack(
            [rr * np.cos(th), rr * np.sin(th),
             rng.randn(quarter).astype(np.float32) * 0.02],
            axis=1,
        )
    )
    n_pil = n - 3 * quarter
    pil_th = rng.rand(80).astype(np.float32) * 2 * np.pi
    pil_r = 19.0 + rng.rand(80).astype(np.float32) * 6.0
    which = rng.randint(0, 80, n_pil)
    ang = rng.rand(n_pil).astype(np.float32) * 2 * np.pi
    out.append(
        np.stack(
            [
                pil_r[which] * np.cos(pil_th[which]) + 0.5 * np.cos(ang),
                pil_r[which] * np.sin(pil_th[which]) + 0.5 * np.sin(ang),
                rng.rand(n_pil).astype(np.float32) * 3.0,
            ],
            axis=1,
        )
    )
    return np.concatenate(out).astype(np.float32)


def ring_trajectory(n_poses: int = 200, lap: int = 100) -> list:
    """Circle r=22 traversed n_poses/lap times; x-axis along the tangent."""
    poses = []
    for i in range(n_poses):
        th = 2 * np.pi * (i % lap) / lap
        c, s = np.cos(th), np.sin(th)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.asarray([[-s, -c, 0], [c, -s, 0], [0, 0, 1]], np.float32)
        T[:3, 3] = np.asarray([22.0 * c, 22.0 * s, 0.5], np.float32)
        poses.append(T)
    return poses


def ring_scans(world: np.ndarray, T_true: list, scan_n: int = 2048,
               noise: float = 0.005, seed: int = 1) -> list:
    """Per pose: the scan_n nearest world points in the local frame + noise
    (the noise is what accumulates into odometry drift)."""
    rng = np.random.RandomState(seed)
    scans = []
    for T in T_true:
        d2 = np.sum((world - T[:3, 3]) ** 2, axis=1)
        idx = np.argpartition(d2, scan_n)[:scan_n]
        local = (world[idx] - T[:3, 3]) @ T[:3, :3]
        local = local + rng.randn(*local.shape).astype(np.float32) * noise
        scans.append(local.astype(np.float32))
    return scans
