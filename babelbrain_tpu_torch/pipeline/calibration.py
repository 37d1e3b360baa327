"""Transducer calibration from hydrophone scans.

Counterpart of ``babelbrain_tpu/pipeline/calibration.py``, the capability
of `BabelBrain/Calibration/TxCalibration.py` (SURVEY.md section 2.7): given
a measured complex pressure field on a plane (hydrophone raster scan at a
known standoff) and the array geometry, fit per-element complex weights so
the modeled Rayleigh field reproduces the measurement. The reference runs a
regularized fitting process (`RUN_FITTING_Process`); here the same problem
is solved directly as Tikhonov-regularized complex least squares:

    min_w || A w - p ||^2 + lam ||w - 1||^2

where A[:, e] is the field of element e with unit drive at the measurement
points. The optional per-element phase-only projection mirrors the
reference's programming constraint for amplitude-locked drive
electronics.

The columns of A come from the port's ``ops.rayleigh.rayleigh_field`` on
``device`` (CUDA by default; plain PyTorch, as the JAX package leaves the
Rayleigh integral to XLA); the normal equations are solved on the host in
float64, as in the JAX package.

The resulting weights feed ``run_acoustic_sim(element_weights=...)`` (the
reference's ``OptimizedWeightsFile``/``AdjustWeightAmplitudes`` path,
`BabelIntegrationBASE.py:2224-2234`).
"""

from __future__ import annotations

import numpy as np

from ..ops.rayleigh import rayleigh_field, steering_phases


def element_field_matrix(wavenumber, tx, points, *,
                         device="cuda") -> np.ndarray:
    """(P, E) complex matrix: field of each physical element (unit drive)."""
    E = tx.num_elements
    A = np.zeros((len(points), E), np.complex64)
    ids = np.asarray(tx.elem_ids)
    for e in range(E):
        sel = ids == e
        u0 = np.zeros(tx.num_subelements, np.complex64)
        u0[sel] = 1.0
        A[:, e] = rayleigh_field(
            wavenumber, tx.centers[sel], tx.areas[sel], u0[sel], points,
            device=device,
        )
    return A


def _tikhonov_solve(A, p, lam):
    """Weights minimising ||A w - p||^2 + lam scale ||w - 1||^2 (scale: the
    mean diagonal of A^H A) and the relative residual."""
    E = A.shape[1]
    AtA = A.conj().T @ A
    scale = np.trace(AtA).real / E
    rhs = A.conj().T @ p + lam * scale * np.ones(E, np.complex128)
    w = np.linalg.solve(AtA + lam * scale * np.eye(E), rhs)
    return w, np.linalg.norm(A @ w - p) / np.linalg.norm(p)


def fit_element_weights(
    wavenumber,
    tx,
    scan_points,
    measured_complex,
    *,
    lam: float = 1e-2,
    phase_only: bool = False,
    device="cuda",
):
    """Fit per-element complex weights to a hydrophone measurement.

    Returns (weights (E,) complex, relative residual). ``lam`` regularizes
    toward the nominal uniform drive (w = 1).
    """
    A = element_field_matrix(wavenumber, tx,
                             np.asarray(scan_points, np.float32),
                             device=device)
    p = np.asarray(measured_complex, np.complex128).ravel()
    w, resid = _tikhonov_solve(A, p, lam)
    if phase_only:
        w = np.exp(1j * np.angle(w))
        resid = np.linalg.norm(A @ w - p) / np.linalg.norm(p)
    return w.astype(np.complex64), float(resid)


def scan_plane_points(x_mm, y_mm, z_m):
    """Build hydrophone raster points (meters) from scan axes in mm."""
    xp, yp = np.meshgrid(
        np.asarray(x_mm, np.float64) * 1e-3,
        np.asarray(y_mm, np.float64) * 1e-3,
        indexing="ij",
    )
    return np.stack(
        [xp.ravel(), yp.ravel(), np.full(xp.size, z_m)], axis=1
    ).astype(np.float32)


def load_hydrophone_profiles(path, sheet=0, cell_range=None):
    """Load measured on-axis hydrophone profiles.

    Input layout follows the reference's calibration spreadsheets
    (`Calibration/TxCalibration.py:26-118,945`): first column = axial Z
    positions (mm), remaining columns = one profile per programmed focal
    location, numeric column headers = the location labels (TPO distances,
    mm). Accepts ``.csv`` (numpy reader, first row = headers) and ``.xlsx``
    when openpyxl is installed; ``cell_range`` like ``"Sheet1!B3:H40"``
    selects an Excel sub-range like the reference's ``ExcelRangeProfiles``.

    Returns ``(z_mm (N,), locations (L,), values (N, L))``.
    """
    path = str(path)
    if path.lower().endswith(".csv"):
        raw = np.genfromtxt(path, delimiter=",", dtype=np.float64)
        if raw.ndim != 2 or raw.shape[0] < 2 or raw.shape[1] < 2:
            raise ValueError(f"{path}: expected a header row + data columns")
        locations = raw[0, 1:]
        z_mm = raw[1:, 0]
        values = raw[1:, 1:]
        return z_mm, locations, values
    try:
        import openpyxl
    except ImportError as e:
        raise ImportError(
            "reading .xlsx hydrophone profiles requires openpyxl; export "
            "the sheet to CSV (Z mm in the first column, one profile per "
            "location column) instead"
        ) from e
    wb = openpyxl.load_workbook(path, data_only=True)
    ws = wb[sheet] if isinstance(sheet, str) else wb.worksheets[sheet]
    if cell_range and "!" in cell_range:
        sheet_name, cell_range = cell_range.split("!", 1)
        ws = wb[sheet_name]
    cells = ws[cell_range] if cell_range else ws.iter_rows()
    rows = [[c.value for c in row] for row in cells]
    rows = [r for r in rows if any(v is not None for v in r)]
    locations = np.array([float(v) for v in rows[0][1:]])
    data = np.array(
        [[float(v) if v is not None else np.nan for v in r] for r in rows[1:]]
    )
    return data[:, 0], locations, data[:, 1:]


def calibrate_annular_from_profiles(
    spec,
    frequency: float,
    z_mm,
    locations_mm,
    profiles,
    phases=None,
    *,
    lam: float = 1e-2,
    sos_water: float = 1500.0,
    amplitude_limit: float = 4.0,
    ppw_surface: float = 8.0,
    device="cuda",
):
    """Per-ring complex weights from measured axial profiles, one fit per
    programmed focal location (the reference's calibration workflow,
    `Calibration/TxCalibration.py:900-1100`).

    For each location the array is programmed with the conjugate-phase
    ring steering for that TPO distance, the measured on-axis profile
    (amplitude; phase from the Rayleigh model when no phase scan is given
    — the reference's ``UseRayleighPhase=True`` default) becomes the
    target field, and Tikhonov complex LSQ recovers the per-ring weights.
    Axial positions and TPO locations are distances from the device
    out-plane; in the focus-at-origin geometry frame the out-plane sits at
    ``-NaturalOutPlaneDistance`` (`TxCalibration.py:950-960`).

    Returns ``{location_mm: {"weights": (R,) complex, "residual": float}}``.
    """
    from .profiles import build_transducer

    z_mm = np.asarray(z_mm, np.float64)
    locations_mm = np.asarray(locations_mm, np.float64)
    profiles = np.asarray(profiles, np.float64)
    k = 2 * np.pi * frequency / sos_water
    tx = build_transducer(spec, frequency, sos_water=sos_water,
                          ppw_surface=ppw_surface)
    outplane = spec.meta["natural_outplane"]
    out = {}
    for li, loc in enumerate(locations_mm):
        pts = np.zeros((len(z_mm), 3), np.float32)
        pts[:, 2] = z_mm * 1e-3 - outplane
        # program the rings toward this location (TPO -> Z steering)
        target_z = loc * 1e-3 - outplane
        w_steer = steering_phases(
            k, _ring_centers(tx), [0.0, 0.0, target_z], device=device
        )
        u0 = _expand_ring_weights(tx, w_steer)
        model = rayleigh_field(k, tx.centers, tx.areas, u0, pts,
                               device=device)
        amp = profiles[:, li]
        good = np.isfinite(amp)
        if phases is not None:
            ph = np.asarray(phases, np.float64)[:, li]
        else:
            ph = np.angle(np.asarray(model))
        target = amp * np.exp(1j * ph)
        # fit per-ring weights relative to the steered drive
        w, resid = _fit_ring_weights(
            k, tx, w_steer, pts[good], target[good], lam, device=device
        )
        mag = np.abs(w)
        w = np.where(mag > amplitude_limit, w / mag * amplitude_limit, w)
        out[float(loc)] = {"weights": w.astype(np.complex64),
                           "residual": float(resid)}
    return out


def _ring_centers(tx):
    """Mean sub-element center per physical ring/element."""
    ids = np.asarray(tx.elem_ids)
    return np.stack([
        tx.centers[ids == e].mean(axis=0) for e in range(tx.num_elements)
    ])


def _expand_ring_weights(tx, w):
    ids = np.asarray(tx.elem_ids)
    return np.asarray(w, np.complex64)[ids]


def _fit_ring_weights(k, tx, w_steer, points, target, lam, *, device="cuda"):
    """LSQ per-ring weights on top of an existing steering drive."""
    A = element_field_matrix(k, tx, points, device=device)
    A = A * np.asarray(w_steer, np.complex128)[None, :]
    return _tikhonov_solve(A, np.asarray(target, np.complex128).ravel(), lam)


def run_calibration(config_path: str, *, device="cuda"):
    """YAML-driven calibration entry point (`TxCalibration.py:902-930`
    input contract: ExcelFileProfiles/ExcelRangeProfiles or a CSV path,
    Lambda, Frequency, TxSystem, OutputResultsPath). Writes one
    ``RingAmplPhase_<location>.h5`` per location with the fitted weights
    (the reference's per-ring weight export consumed as
    ``OptimizedWeightsFile``)."""
    import os

    import yaml

    from . import io as pio
    from .profiles import TRANSDUCER_REGISTRY

    with open(config_path) as f:
        params = yaml.safe_load(f)
    spec = TRANSDUCER_REGISTRY[params["TxSystem"]]
    z_mm, locs, vals = load_hydrophone_profiles(
        params["ExcelFileProfiles"],
        cell_range=params.get("ExcelRangeProfiles"),
    )
    phases = None
    if params.get("ExcelFilePhase"):
        _, _, phases = load_hydrophone_profiles(
            params["ExcelFilePhase"],
            cell_range=params.get("ExcelRangePhase"),
        )
    fits = calibrate_annular_from_profiles(
        spec, float(params["Frequency"]), z_mm, locs, vals, phases,
        lam=float(params.get("Lambda", 1e-2)),
        amplitude_limit=float(params.get("AmplitudeLimit", 4.0)),
        device=device,
    )
    outdir = params["OutputResultsPath"]
    os.makedirs(outdir, exist_ok=True)
    written = []
    for loc, fit in fits.items():
        path = os.path.join(outdir, f"RingAmplPhase_{loc:.1f}.h5")
        pio.save_dict_h5(
            {
                "Amplitudes": np.abs(fit["weights"]),
                "Phases": np.angle(fit["weights"]),
                "Residual": fit["residual"],
                "LocationMM": loc,
                "TxSystem": params["TxSystem"],
                "Frequency": float(params["Frequency"]),
            },
            path,
        )
        written.append(path)
    return written
