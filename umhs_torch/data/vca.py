"""Vertex Component Analysis (VCA) endmember extraction
(port of umhs_tpu/data/vca.py; host-side numpy, runs once per scene).

Nascimento & Bioucas-Dias' VCA initialises the endmember matrix. Both the
low-SNR and the high-SNR projection branches always execute as written
(the original's low-SNR branch ran only when verbose).
"""

from __future__ import annotations

import numpy as np


def estimate_snr(Y: np.ndarray, r_m: np.ndarray, x: np.ndarray) -> float:
    """SNR (dB) of data Y (L, N) with mean r_m (L, 1) and p-dim projection x."""
    L, N = Y.shape
    p = x.shape[0]
    power_y = np.sum(Y**2) / float(N)
    power_x = np.sum(x**2) / float(N) + np.sum(r_m**2)
    return float(10.0 * np.log10((power_x - p / L * power_y) / (power_y - power_x)))


def vca(
    Y: np.ndarray,
    num_endmembers: int,
    snr_input: float = 0.0,
    rng: np.random.Generator | None = None,
    verbose: bool = False,
):
    """VCA of Y (L bands, N pixels) -> (Ae (L, R), indices (R,), Yp (L, N))."""
    if Y.ndim != 2:
        raise ValueError("Y must be (bands, pixels)")
    L, N = Y.shape
    R = int(num_endmembers)
    if R < 1 or R > L:
        raise ValueError("num_endmembers must be in [1, L]")
    if rng is None:
        rng = np.random.default_rng(0)
    Y = np.asarray(Y, dtype=np.float64)

    y_mean = np.mean(Y, axis=1, keepdims=True)
    Y_zero = Y - y_mean
    Ud = np.linalg.svd(Y_zero @ Y_zero.T / float(N))[0][:, :R]
    x_p = Ud.T @ Y_zero
    snr = estimate_snr(Y, y_mean, x_p) if snr_input == 0.0 else float(snr_input)
    snr_threshold = 15.0 + 10.0 * np.log10(R)
    if verbose:
        print(f"VCA: SNR = {snr:.2f} dB (threshold {snr_threshold:.2f})")

    if snr < snr_threshold:
        # low SNR: project to R-1 dims, lift back, append a constant row
        d = R - 1
        Yp = Ud[:, :d] @ x_p[:d, :] + y_mean
        x = x_p[:d, :]
        if d > 0:
            c = np.amax(np.sum(x**2, axis=0)) ** 0.5
        else:
            x = np.zeros((0, N))
            c = 1.0
        y = np.vstack((x, c * np.ones((1, N))))
    else:
        # high SNR: projective projection onto R dims
        Ud_d = np.linalg.svd(Y @ Y.T / float(N))[0][:, :R]
        x = Ud_d.T @ Y
        Yp = Ud_d @ x
        u = np.mean(x, axis=1, keepdims=True)
        y = x / (u.T @ x + 1e-6)

    indices = np.zeros(R, dtype=int)
    A = np.zeros((R, R))
    A[-1, 0] = 1.0
    for i in range(R):
        w = rng.random((R, 1))
        f = w - A @ (np.linalg.pinv(A) @ w)
        f = f / (np.linalg.norm(f) + 1e-12)
        v = f.T @ y
        indices[i] = int(np.argmax(np.abs(v)))
        A[:, i] = y[:, indices[i]]
    return Yp[:, indices], indices, Yp


def vca_endmembers_from_cube(
    cube: np.ndarray, num_endmembers: int, rng: np.random.Generator | None = None
) -> np.ndarray:
    """VCA of an (H, W, B) cube clamped to [0, 1] -> (num_endmembers, B) f32."""
    cube = np.clip(np.asarray(cube, dtype=np.float64), 0.0, 1.0)
    Ae, _, _ = vca(cube.reshape(-1, cube.shape[-1]).T, num_endmembers, rng=rng)
    return Ae.T.astype(np.float32)
