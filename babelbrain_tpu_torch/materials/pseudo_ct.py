"""ZTE / PETRA MRI to pseudo-CT conversion.

Re-implements `BabelBrain/CTZTEProcessing.py:501-628` (``ConvertZTE_PETRA_pCT``):
normalize the ZTE/PETRA intensity image, then map normalized intensity to
Hounsfield units with the published linear calibrations

    ZTE   (Miscouridou 2022):  pCT = -2085 * norm + 2329
    PETRA (SimNIBS petra2Density / UCL): pCT = -2080 * norm + 2133.2

(defaults `BabelBrain/Options/Options.py:99-108`), with air/background set
to -1000 HU. Normalization differs per modality:
  * ZTE: divide by the 95th percentile of the brain-tissue-masked image
    (`:591-594`);
  * PETRA: integer-binned intensity histogram, find the top
    ``n_peaks`` peaks at least ``peak_distance`` intensity units apart and
    divide by the highest-intensity one (`:556-577`).
The bone region is the largest connected component of normalized values in
``norm_range`` (default 0.1-0.6, the GUI ZTE range slider default,
`BabelBrain.py:704`), closed with an 11^3 structuring element (`:598-609`).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage, signal

ZTE_SLOPE, ZTE_OFFSET = -2085.0, 2329.0
PETRA_SLOPE, PETRA_OFFSET = -2080.0, 2133.2


def normalize_zte(zte: np.ndarray, head_mask: np.ndarray,
                  tissue_mask: np.ndarray | None = None):
    """Normalize ZTE by the 95th percentile over brain tissue
    (`CTZTEProcessing.py:591-594`); voxels outside the head become -0.5."""
    masked = np.where(
        tissue_mask if tissue_mask is not None else head_mask, zte, -1000.0
    )
    cutoff = np.percentile(masked[masked > -500], 95)
    norm = zte / cutoff
    return np.where(head_mask, norm, -0.5)


def normalize_petra(
    petra: np.ndarray,
    head_mask: np.ndarray,
    peak_distance: float = 50.0,
    n_peaks: int = 2,
):
    """Normalize PETRA by the highest-intensity of the ``n_peaks`` tallest
    histogram peaks (`CTZTEProcessing.py:556-577`; SimNIBS petra2Density).

    The histogram is integer-binned over the full intensity range with the
    zero-intensity bin dropped, and peaks must be at least ``peak_distance``
    intensity units apart (defaults `Options.py:99-100`)."""
    arr = np.asarray(petra, np.float64)
    if arr.max() - arr.min() > 2**16 - 1:
        raise ValueError("PETRA intensity range exceeds 2^16")
    edges = np.arange(int(arr.min()), int(arr.max()) + 2) - 0.5
    hist, e = np.histogram(arr.ravel().astype(int), bins=edges)
    bins = 0.5 * (e[1:] + e[:-1])
    bins, hist = bins[1:], hist[1:]  # drop the background/zero bin
    dist = max(int(peak_distance / np.mean(np.diff(bins))), 1)
    pks, _ = signal.find_peaks(hist, distance=dist)
    order = np.argsort(hist[pks])[::-1][:n_peaks]
    ref = np.max(bins[pks][order])
    return arr / ref


def select_bone_region(norm: np.ndarray, head_mask: np.ndarray,
                       norm_range: tuple = (0.1, 0.6)) -> np.ndarray:
    """Largest connected component of in-range normalized intensity, closed
    with an 11^3 structure (`CTZTEProcessing.py:598-609`). Voxels outside a
    3-iteration erosion of the head are excluded first."""
    guard = norm.copy()
    guard[ndimage.binary_erosion(head_mask, iterations=3) == 0] = guard.max()
    arr = (guard >= norm_range[0]) & (guard <= norm_range[1])
    lab, n = ndimage.label(arr)
    if n == 0:
        return np.zeros(norm.shape, bool)
    largest = np.argmax(np.bincount(lab.ravel())[1:]) + 1
    return ndimage.binary_closing(lab == largest, structure=np.ones((11,) * 3))


def mri_to_pseudo_ct(
    image: np.ndarray,
    head_mask: np.ndarray,
    modality: str = "ZTE",
    *,
    slope: float | None = None,
    offset: float | None = None,
    norm_range: tuple = (0.1, 0.6),
    air_hu: float = -1000.0,
    tissue_mask: np.ndarray | None = None,
    cavity_mask: np.ndarray | None = None,
    petra_peak_distance: float = 50.0,
    petra_n_peaks: int = 2,
) -> np.ndarray:
    """Convert a ZTE or PETRA image to pseudo-CT HU.

    Mirrors `CTZTEProcessing.py:556-625`: soft tissue inside the head gets
    42 HU, the bone region (largest in-range component, closed) gets the
    linear calibration, values outside [-1000, 3300] and cavity voxels
    become air.
    """
    modality = modality.upper()
    if modality == "ZTE":
        norm = normalize_zte(image, head_mask, tissue_mask)
        s = ZTE_SLOPE if slope is None else slope
        o = ZTE_OFFSET if offset is None else offset
    elif modality == "PETRA":
        norm = normalize_petra(image, head_mask, petra_peak_distance,
                               petra_n_peaks)
        s = PETRA_SLOPE if slope is None else slope
        o = PETRA_OFFSET if offset is None else offset
    else:
        raise ValueError(f"modality must be ZTE or PETRA, got {modality}")

    bone = select_bone_region(norm, head_mask, norm_range)
    pct = np.full(image.shape, air_hu, np.float64)
    pct[head_mask] = 42.0  # soft tissue (`:614-615`)
    pct[bone] = s * norm[bone] + o
    pct[(pct < -1000) | (pct > 3300)] = air_hu  # `:621-622`
    if cavity_mask is not None:
        pct[cavity_mask] = air_hu
    return pct


def compute_sdr(hu_volume, skull_mask, spacing_mm=1.0, ray_spacing_mm=1.8,
                min_skull_voxels=3, center_region=0.5):
    """Skull density ratio: mean over z-rays of min(center HU)/max(HU)
    (`TranscranialModeling/BabelIntegrationBASE.py:816-854`, SkullGAN
    definition)."""
    vol = np.asarray(hu_volume)
    mask = np.asarray(skull_mask).astype(bool)
    step = max(1, int(round(ray_spacing_mm / spacing_mm)))
    vals = []
    for i in range(0, vol.shape[0], step):
        for j in range(0, vol.shape[1], step):
            ray = vol[i, j, :]
            sk = np.nonzero(mask[i, j, :])[0]
            if sk.size < min_skull_voxels:
                continue
            mid = len(sk) // 2
            half = len(sk) * center_region / 2
            b = max(0, int(round(mid - half)))
            e = min(len(sk), 1 + int(round(mid + half)))
            # min over the *skull voxels* of the central region (gaps between
            # skull voxels are water/marrow-labeled and carry no HU here)
            center_min = ray[sk[b:e]].min() if e > b else ray[sk[mid]]
            m = ray[sk].max()
            if m > 0:
                vals.append(center_min / m)
    return float(np.mean(vals)) if vals else float("nan")
