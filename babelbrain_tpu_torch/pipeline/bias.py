"""MRI intensity bias-field correction (the N4ITK-subprocess replacement).

The reference runs SimpleITK's N4 bias correction on ZTE/PETRA images before
pseudo-CT conversion (`BabelBrain/CTZTEProcessing.py:168`). This module
implements the same capability as a smooth multiplicative bias estimate:
fit a low-order 3-D polynomial to the log-intensity of head voxels by
weighted least squares (closed form, one lstsq on a few tens of
coefficients), and divide it out. For the piecewise-constant-ish tissue
intensities of ZTE/PETRA this removes the slowly-varying coil shading that
matters for the histogram-based pCT normalization.

Numpy copy of ``babelbrain_tpu/pipeline/bias.py`` (host code; the port
imports nothing of that package).
"""

from __future__ import annotations

import numpy as np


def _poly_basis(shape, order):
    """Normalized polynomial basis evaluated on the grid, (V, n_terms)."""
    coords = [
        (np.arange(n, dtype=np.float64) / max(n - 1, 1)) * 2.0 - 1.0
        for n in shape
    ]
    ii, jj, kk = np.meshgrid(*coords, indexing="ij")
    terms = []
    for a in range(order + 1):
        for b in range(order + 1 - a):
            for c in range(order + 1 - a - b):
                terms.append((ii**a) * (jj**b) * (kk**c))
    return np.stack([t.ravel() for t in terms], axis=1)


def _bspline_1d(n, n_ctrl):
    """(n, n_ctrl) cubic B-spline design matrix on a uniform control grid."""
    x = np.arange(n, dtype=np.float64) / max(n - 1, 1) * (n_ctrl - 3)
    B = np.zeros((n, n_ctrl))
    for c in range(n_ctrl):
        t = x - (c - 1)  # control point c anchors knot c-1
        at = np.abs(t)
        val = np.where(
            at < 1, (4 - 6 * at**2 + 3 * at**3) / 6,
            np.where(at < 2, (2 - at) ** 3 / 6, 0.0),
        )
        B[:, c] = val
    return B


class _BsplineBasis:
    """Separable 3-D cubic B-spline basis, evaluated lazily.

    The basis family N4ITK itself fits (a B-spline lattice,
    `BabelBrain/CTZTEProcessing.py:168` runs SimpleITK N4): locally
    supported control points follow bias shapes a global polynomial
    cannot (e.g. a surface-coil hot spot in one octant). The dense
    (V, n_ctrl^3) matrix would be GBs at head-volume sizes, so rows are
    built only for the fitted voxels and the full-grid evaluation uses
    the separable contraction.
    """

    def __init__(self, shape, n_ctrl):
        self.shape = tuple(shape)
        self.n_ctrl = n_ctrl
        self.B = [_bspline_1d(n, n_ctrl) for n in shape]
        self.n_terms = n_ctrl**3

    def rows(self, sel_flat):
        ii, jj, kk = np.unravel_index(np.nonzero(sel_flat)[0], self.shape)
        r = (
            self.B[0][ii][:, :, None, None]
            * self.B[1][jj][:, None, :, None]
            * self.B[2][kk][:, None, None, :]
        )
        return r.reshape(len(ii), self.n_terms)

    def eval(self, coef):
        c = np.asarray(coef).reshape((self.n_ctrl,) * 3)
        return np.einsum(
            "ia,jb,kc,abc->ijk", self.B[0], self.B[1], self.B[2], c
        )


class _DenseBasis:
    def __init__(self, mat, shape):
        self.mat = mat
        self.shape = shape
        self.n_terms = mat.shape[1]

    def rows(self, sel_flat):
        return self.mat[sel_flat]

    def eval(self, coef):
        return (self.mat @ coef).reshape(self.shape)


def correct_bias_field(
    image: np.ndarray,
    mask: np.ndarray,
    order: int = 3,
    clip_percentiles=(2.0, 98.0),
    basis: str = "poly",
    n_ctrl: int = 6,
):
    """Estimate and remove a smooth multiplicative bias field.

    Returns (corrected_image, bias_field). The corrected image preserves the
    median intensity inside ``mask``.

    ``basis='poly'`` fits a global polynomial of ``order``;
    ``basis='bspline'`` fits an N4-style cubic B-spline lattice with
    ``n_ctrl`` control points per axis (locally supported, so it follows
    coil-shading patterns a global polynomial cannot).
    """
    img = np.asarray(image, np.float64)
    m = np.asarray(mask, bool)
    if basis == "bspline":
        bas = _BsplineBasis(img.shape, n_ctrl)
    elif basis == "poly":
        bas = _DenseBasis(
            np.ascontiguousarray(_poly_basis(img.shape, order)), img.shape
        )
    else:
        raise ValueError("basis must be 'poly' or 'bspline'")

    corrected = img.copy()
    total_log_bias = np.zeros(img.shape)
    for _ in range(3):
        # fit only the dominant intensity mode (N4's histogram-sharpening
        # idea): tissue near the in-mask median, excluding bone/air
        med = np.median(corrected[m & (corrected > 0)])
        sel = m & (corrected > 0.65 * med) & (corrected < 1.5 * med)
        if sel.sum() < bas.n_terms * 4:
            break
        logv = np.log(corrected[sel])
        A = bas.rows(sel.ravel())
        coef, *_ = np.linalg.lstsq(A, logv - logv.mean(), rcond=None)
        log_b = bas.eval(coef)
        total_log_bias += log_b
        corrected = corrected / np.exp(log_b)

    total_log_bias -= np.median(total_log_bias[m])
    bias = np.exp(total_log_bias)
    corrected = img / bias
    return corrected, bias
