"""Port parity: the K-step BHTE sweep (``bhte_run(fuse_steps=)``) against
JAX's B9 driver, and the sweep kernel's march.

* ``bhte_run(fuse_steps=k)`` on the CPU runs JAX's segment schedule (n // K
  sweeps of ``bhte_fused``, whose plain version is K steps of
  ``bhte_step_ref``, then n % K single steps) and samples the monitors
  after each launch. It is held to JAX's ``bhte_run(backend="pallas")`` and
  to ``bhte_segment_pallas(fuse_steps=k, interpret=True)`` chained over the
  segments, at JAX's own bands for B9 (`tests/test_bhte.py:378-400`):
  temperature and peak atol 1e-5 C, dose rtol 1e-6, monitors atol 1e-5;
  ``monitor_steps`` exactly.
* Against the one-step schedule (``fuse_steps=1``) bit for bit, monitors
  equal at the sampled steps.
* ``run_all_combinations`` with the sweeps against JAX's with its Pallas
  driver (both at K = 3, by monkeypatch).
* ``run_case``'s ``_ThermalField.h5`` read back: ``TemperaturePointsSteps``
  gives each ``TemperaturePoints`` sample's step at K = 1 and K = 3.
* ``march``: a numpy copy of ``bhte_fused_kernel``'s block loop (each
  column's registers, the stages' planes in shared memory, the one barrier
  a march step, the live planes and owned cells) equals K steps of the
  plain version (temperature and peak bit for bit; dose within 1e-6,
  numpy's exp2 against torch's), on grids whose N1 is below K, whose N2 and
  N3 are below a tile, and with many x-segments.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from babelbrain_tpu.materials import build_thermal_material_list, material_array
from babelbrain_tpu.ops import bhte as J
from babelbrain_tpu.ops import bhte_pallas as JP
from babelbrain_tpu.pipeline import thermal as JT
from babelbrain_tpu_torch.ops import bhte as T
from babelbrain_tpu_torch.ops import bhte_kernels as BK
from babelbrain_tpu_torch.pipeline import thermal as TT

torch.set_num_threads(2)

DX, DT = 5e-4, 0.01


def _setup(shape=(32, 32, 40)):
    """`tests/test_bhte.py`'s ``TestBHTEPallas`` layers and heat blob."""
    acoustic = material_array(
        500e3, tissues=("Water", "Skin", "Cortical", "Trabecular", "Brain")
    )
    mats = build_thermal_material_list(acoustic, ct_mode=False,
                                       segmented_brain=False)
    idx = np.zeros(shape, np.uint8)
    idx[:, :, 10:14] = 1
    idx[:, :, 14:20] = 2
    idx[:, :, 20:] = 4
    p = np.zeros(shape, np.float32)
    p[12:20, 12:20, 24:32] = 2e6
    return mats, idx, p


SCHEDULE = [(0, 13, True), (0, 8, False), (0, 5, True)]
COMMON = dict(dt=DT, duty_cycle=0.3, monitor_points=[(16, 16, 28)],
              arterial_temperature=37.0)


def _jax_segments(p, idx, mats, sched, k):
    """JAX's B9 driver at a pinned K: ``bhte_segment_pallas(fuse_steps=k,
    interpret=True)`` segment by segment, as its ``bhte_run`` chains them."""
    coeff = {n: jnp.asarray(v)
             for n, v in J._build_coeff_maps(idx, mats, DX, DT).items()}
    km, inv_dx2 = coeff["k"], coeff["inv_dx2"]
    c6 = [J._harmonic_mean(km, J._shift(km, off, ax)) * inv_dx2
          for ax in range(3) for off in (1, -1)]
    c6 += [coeff["inv_rho_cp_dt"], coeff["perf_dt"]]
    t_init = np.asarray(mats.init_temperature, np.float64)[idx]
    Tj = jnp.asarray(t_init, jnp.float32)
    dose = jnp.zeros(idx.shape, jnp.float32)
    peak = jnp.full(idx.shape, -1e9, jnp.float32)
    q = jnp.asarray(J.absorption_heating(p, idx, mats, COMMON["duty_cycle"]))
    mp = np.asarray(COMMON["monitor_points"])
    flat = jnp.asarray(np.ravel_multi_index(tuple(mp.T), idx.shape))
    mons, steps, step0 = [], [], 0
    for f, n, on in sched:
        Tj, dose, peak, m, ms = JP.bhte_segment_pallas(
            Tj, dose, peak, q if on and f >= 0 else None, c6, n,
            COMMON["arterial_temperature"], flat, interpret=True,
            fuse_steps=k)
        mons.append(np.asarray(m))
        steps.append(ms + step0)
        step0 += n
    return J.BHTEResult(
        temperature=np.asarray(Tj), peak_temperature=np.asarray(peak),
        dose=np.asarray(dose) * DT, monitor=np.concatenate(mons).T,
        monitor_steps=np.concatenate(steps))


@pytest.mark.parametrize("k", ["auto", 2, 3, 5])
def test_sweeps_match_jax_b9_driver(k):
    """``k="auto"``: JAX's ``bhte_run(backend="pallas")`` with its own depth
    (``_bhteK_auto``), the port pinned to it; else JAX's segment driver
    pinned to ``k``."""
    mats, idx, p = _setup()
    if k == "auto":
        k = JP._bhteK_auto(idx.shape, 4)
        assert k == JP._bhteK_auto(idx.shape, 4, with_q=False) >= 2
        ref = J.bhte_run(p, idx, mats, DX, SCHEDULE, backend="pallas",
                         **COMMON)
    else:
        ref = _jax_segments(p, idx, mats, SCHEDULE, k)
    got = T.bhte_run(p, idx, mats, DX, SCHEDULE, device="cpu", fuse_steps=k,
                     **COMMON)
    np.testing.assert_array_equal(got.monitor_steps, ref.monitor_steps)
    np.testing.assert_array_equal(got.monitor_steps,
                                  T.monitor_steps(SCHEDULE, k))
    np.testing.assert_allclose(got.temperature, ref.temperature, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got.peak_temperature, ref.peak_temperature,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.dose, ref.dose, rtol=1e-6)
    assert got.monitor.shape == ref.monitor.shape
    np.testing.assert_allclose(got.monitor, ref.monitor, rtol=0, atol=1e-5)
    assert got.peak_temperature.max() > 37.05


FIELDS_SCHEDULE = [(0, 6, True), (1, 6, True), (-1, 4, False), (1, 3, True)]


@pytest.mark.parametrize("case, k", [
    ("fields", 2), ("fields", 4), ("fields", 8),  # two heat maps, on / off
    ("short", 4),  # segments shorter than K: tails only
    ("thin", 5),   # N1 = 3 < K
])
def test_sweeps_equal_one_step(case, k):
    shape = (3, 20, 24) if case == "thin" else (32, 32, 40)
    mats, idx, p = _setup(shape)
    if case == "thin":
        idx[:] = np.where(np.arange(24) < 8, 0, 4)
        p[:, 6:14, 10:18] = 2e6
    p2 = np.roll(p, 6, axis=1)
    sched = {"fields": FIELDS_SCHEDULE, "short": [(0, 3, True), (0, 2, False)],
             "thin": [(0, 12, True), (0, 7, False)]}[case]
    kw = dict(dt=DT, duty_cycle=0.5, device="cpu",
              monitor_points=[(1, 10, 14), (0, 0, 0), (2, 19, 23)])
    one = T.bhte_run(np.stack([p, p2]), idx, mats, DX, sched, fuse_steps=1,
                     **kw)
    fused = T.bhte_run(np.stack([p, p2]), idx, mats, DX, sched, fuse_steps=k,
                       **kw)
    for name in ("temperature", "peak_temperature", "dose"):
        np.testing.assert_array_equal(getattr(fused, name), getattr(one, name),
                                      err_msg=name)
    np.testing.assert_array_equal(one.monitor_steps,
                                  np.arange(sum(n for _, n, _ in sched)))
    np.testing.assert_array_equal(fused.monitor,
                                  one.monitor[:, fused.monitor_steps])
    assert one.peak_temperature.max() > 37.01


def test_run_all_combinations_with_sweeps_matches_jax_pallas(monkeypatch):
    """Step 3 through the pipeline with the sweeps at K = 3 on both sides:
    the port's ``bhte_run(fuse_steps=3)`` against JAX's Pallas driver
    (``backend="pallas"``, ``bhte_segment_pallas(fuse_steps=3)``)."""
    shape = (24, 24, 32)
    mm = np.zeros(shape, np.uint8)
    mm[:, :, 8:10], mm[:, :, 10:12], mm[:, :, 12:14], mm[:, :, 14:] = 1, 2, 3, 4
    mats = material_array(5e5, ("Water", "Skin", "Cortical", "Trabecular",
                                "Brain"))
    ii, jj, kk = np.mgrid[:24, :24, :32].astype(float)
    blob = np.exp(-(((ii - 12) ** 2 + (jj - 12) ** 2) / 8.0
                    + ((kk - 22) ** 2) / 18.0))
    p, pw = (1e5 * blob).astype(np.float32), (1.2e5 * blob).astype(np.float32)
    combo = dict(duration_on=0.11, duration_off=0.05, duty_cycle=0.5,
                 prf=100.0, isppa=8.0)
    monkeypatch.setattr(TT, "bhte_run",
                        functools.partial(T.bhte_run, fuse_steps=3))
    monkeypatch.setattr(JT, "bhte_run",
                        functools.partial(J.bhte_run, backend="pallas"))
    monkeypatch.setattr(JP, "bhte_segment_pallas",
                        functools.partial(JP.bhte_segment_pallas,
                                          fuse_steps=3))
    args = (p, pw, mm, mats, 1e-3, (12, 12, 22))
    rj, cj = JT.run_all_combinations(*args, [JT.SonicationParams(**combo)])
    rt, ct = TT.run_all_combinations(*args, [TT.SonicationParams(**combo)],
                                     device="cpu")
    a, b = rt[0], rj[0]
    # 11 on, 5 off: sweeps ending at steps 2, 5, 8, tails 9, 10; 13, 14, 15
    np.testing.assert_array_equal(a.monitor_steps,
                                  [2, 5, 8, 9, 10, 13, 14, 15])
    np.testing.assert_array_equal(a.monitor_steps, b.monitor_steps)
    np.testing.assert_allclose(a.temperature_end, b.temperature_end, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(a.dose, b.dose, rtol=1e-6)
    np.testing.assert_allclose(a.monitor, b.monitor, rtol=0, atol=1e-5)
    st, sj = ct["AllData"]["0"], cj["AllData"]["0"]
    np.testing.assert_array_equal(st["TimeProfileTarget"],
                                  sj["TimeProfileTarget"])
    np.testing.assert_allclose(st["TempProfileTarget"],
                               sj["TempProfileTarget"], rtol=0, atol=1e-5)
    for key in ("TI", "TIC", "TIS", "MaxBrainPressure", "MaxIsppa", "MI"):
        assert st[key] == pytest.approx(sj[key], rel=1e-5, abs=1e-9), key
    assert a.metrics["TI"] > 0


def test_thermal_field_file_holds_the_sample_steps(tmp_path, monkeypatch):
    """``run_case``'s ``_ThermalField.h5`` writes the step of each
    ``TemperaturePoints`` sample beside it (``TemperaturePointsSteps``):
    every step one step a launch, each sweep's last step and each tail step
    at K = 3, where the samples equal the one-step run's at those steps."""
    from babelbrain_tpu_torch.pipeline import io as tio
    from babelbrain_tpu_torch.pipeline import runner as TR

    n = 64
    aff = np.diag([2.0, 2.0, 2.0, 1.0])
    aff[:3, 3] = -64.0
    r = np.linalg.norm(np.indices((n, n, n)) * 2.0 - 64.0, axis=0)
    labels = np.select([r < 30, r < 36, r < 40], [2, 7, 5], 0).astype(np.int32)
    son = TT.SonicationParams(duration_on=0.11, duration_off=0.05,
                              duty_cycle=0.3, isppa=10.0)
    files, steps = {}, {}
    for k in (1, 3):
        monkeypatch.setattr(TT, "bhte_run",
                            functools.partial(T.bhte_run, fuse_steps=k))
        cfg = TR.CaseConfig(tx_system="Single", frequency=200e3, ppw=6.0,
                            device="cpu", prefix=f"k{k}",
                            output_dir=str(tmp_path / f"k{k}"))
        res = TR.run_case(cfg, labels, aff, [0, 0, 20], [0, 0, -1],
                          thermal_params=son, mask_shape=(24, 24, 32))
        files[k] = tio.load_dict_h5(res["files"]["thermal"])
        steps[k] = res["thermal"].monitor_steps
    one, fused = files[1], files[3]
    n_steps = np.asarray(one["TemperaturePoints"]).shape[-1]
    np.testing.assert_array_equal(one["TemperaturePointsSteps"],
                                  np.arange(n_steps))
    # 11 on, 5 off: sweeps ending at steps 2, 5, 8, tails 9, 10; 13, 14, 15
    np.testing.assert_array_equal(fused["TemperaturePointsSteps"],
                                  [2, 5, 8, 9, 10, 13, 14, 15])
    np.testing.assert_array_equal(fused["TemperaturePointsSteps"], steps[3])
    np.testing.assert_array_equal(
        fused["TemperaturePoints"],
        np.asarray(one["TemperaturePoints"])[:, steps[3]])
    np.testing.assert_array_equal(fused["FinalTemp"], one["FinalTemp"])


def test_cpu_sweeps_count_plain_calls():
    mats, idx, p = _setup((12, 16, 20))
    sched = [(0, 7, True), (0, 5, False)]
    for d in (BK.launches, BK.plain_calls):
        for key in d:
            d[key] = 0
    T.bhte_run(p, idx, mats, DX, sched, device="cpu", fuse_steps=3)
    assert T.schedule_launches(sched, 3) == {"bhte_fused": 3, "bhte_step": 3}
    assert BK.launches == {"bhte_step": 0, "bhte_fused": 0}
    # 3 sweeps of K = 3 plain steps each, and 3 single steps
    assert BK.plain_calls == {"bhte_fused": 3, "bhte_step": 12}
    assert T.fuse_depth(None, "cpu") == 1
    assert T.fuse_depth(None, "cuda") == BK.BHTE_FUSE_BEST >= 2
    for bad in (0, 9, 2.5):
        with pytest.raises(ValueError, match="fuse_steps"):
            T.fuse_depth(bad, "cpu")


@pytest.mark.parametrize("bad, match", [
    ("alias", "alias"), ("k0", "1..8"), ("k9", "1..8"),
    ("dtype", "float32"), ("device", "float32 on cpu"),
])
def test_fused_wrapper_rejects_bad_inputs(bad, match):
    mats, idx, _ = _setup((8, 10, 12))
    co = T.make_bhte_coeffs(T._build_coeff_maps(idx, mats, DX, DT), "cpu")
    Tm = torch.full(idx.shape, 37.0)
    dose, peak = torch.zeros(idx.shape), torch.zeros(idx.shape)
    k, out = 2, None
    if bad == "alias":
        out = Tm
    elif bad in ("k0", "k9"):
        k = int(bad[1])
    elif bad == "dtype":
        dose = dose.double()
    else:
        co.irc = co.irc.to("meta")
    with pytest.raises(ValueError, match=match):
        BK.bhte_fused(Tm, dose, peak, co, None, 37.0, k, T_out=out)


# ---------------------------------------------------------------------------
# the kernel's march, in numpy
# ---------------------------------------------------------------------------


def march(T0, dose, peak, co, q, t_art, K):
    """``bhte_fused_kernel<K>``'s block loop in numpy, block by block, all
    threads of a block (one a column of the extended tile) at once: each
    column's registers (stage s's last three planes, the coefficients of the
    K + 1 planes in flight, the dose / peak partial sums), the stages' last
    two planes in shared memory by parity, the live planes of each stage,
    the domain-edge replication and the owned cells it writes. Shared memory
    is read as it stood at the last barrier (one a march step), and a march
    step may not write a plane it reads. Unwritten cells stay NaN."""
    n1, n2, n3 = T0.shape
    TZ, TY = BK.FUSED_TILE_Z, BK.fused_tile_y(K)
    (gz, gy, gx), seg = BK.fused_launch_geometry(T0.shape, K)
    EZ, EY = TZ + 2 * K, TY + 2 * K
    f32 = np.float32
    vols = list(co) + ([q] if q is not None else [])
    T_out = np.full_like(T0, np.nan)
    dose, peak = dose.copy(), peak.copy()
    writes = np.zeros(T0.shape, np.int64)
    ey, ez = np.mgrid[:EY, :EZ]
    for bz, by, bx in np.ndindex(gz, gy, gx):
        y, z = by * TY - K + ey, bz * TZ - K + ez
        inside = (y >= 0) & (y < n2) & (z >= 0) & (z < n3)
        owned = inside & (ey >= K) & (ey < K + TY) & (ez >= K) & (ez < K + TZ)
        yc, zc = np.clip(y, 0, n2 - 1), np.clip(z, 0, n3 - 1)
        x0 = bx * seg
        x1 = min(n1, x0 + seg)
        xs, xe = max(0, x0 - K), min(n1 - 1, x1 - 1 + K)
        nan = np.full((EY, EZ), np.nan, f32)
        w = [[nan] * 3 for _ in range(K)]
        cf = [[nan] * len(vols) for _ in range(K + 1)]
        dp, pp = [nan] * K, [nan] * K
        lat = np.full((K, 2, EY, EZ), np.nan, f32)
        t_next = T0[xs, yc, zc]
        d_next = p_next = nan
        for m in range(x1 - 1 - xs + K + 1):
            seen = lat.copy()  # as at the last barrier
            read, wrote = set(), set()
            pl = xs + m
            w[0] = w[0][1:] + [t_next]
            lat[0, pl & 1] = t_next
            wrote.add((0, pl & 1))
            cf = [None] + cf[:-1]
            d1, p1 = d_next, p_next
            if pl + 1 <= xe:
                t_next = T0[pl + 1, yc, zc]
            cf[0] = ([v[pl, yc, zc] for v in vols] if pl <= xe
                     else cf[1])
            if x0 <= pl < x1:
                d_next, p_next = dose[pl, yc, zc], peak[pl, yc, zc]
            cd, cpk = d1, p1
            for k in range(1, K + 1):
                p = pl - k
                lo = 0 if xs == 0 else xs + k
                hi = n1 - 1 if xe == n1 - 1 else xe - k
                tc = w[k - 1][1]
                tn = tc
                if lo <= p <= hi:
                    L = seen[k - 1, p & 1]
                    read.add((k - 1, p & 1))
                    txp = w[k - 1][2] if p + 1 < n1 else tc
                    txm = w[k - 1][0] if p >= 1 else tc
                    typ = np.where((y + 1 < n2) & (ey + 1 < EY),
                                   np.roll(L, -1, 0), tc)
                    tym = np.where((y >= 1) & (ey >= 1), np.roll(L, 1, 0), tc)
                    tzp = np.where((z + 1 < n3) & (ez + 1 < EZ),
                                   np.roll(L, -1, 1), tc)
                    tzm = np.where((z >= 1) & (ez >= 1), np.roll(L, 1, 1), tc)
                    c = cf[k]
                    lap = (c[0] * (txp - tc) + c[1] * (txm - tc)
                           + c[2] * (typ - tc) + c[3] * (tym - tc)
                           + c[4] * (tzp - tc) + c[5] * (tzm - tc))
                    tn = tc + lap * c[6] + c[7] * (f32(t_art) - tc)
                    if q is not None:
                        tn = tn + c[8] * c[6]
                    tn = np.where(inside, tn, tc)
                log2r = np.where(tn >= 43.0, f32(-1.0), f32(-2.0))
                d = cd + np.exp2(log2r * (f32(43.0) - tn))
                pk = np.maximum(cpk, tn)
                if k < K:
                    w[k] = w[k][1:] + [tn]
                    lat[k, p & 1] = tn
                    wrote.add((k, p & 1))
                    cd, cpk, dp[k], pp[k] = dp[k], pp[k], d, pk
                elif lo <= p <= hi and x0 <= p < x1:
                    sel = owned
                    assert not np.isnan(tn[sel]).any(), (m, k, p)
                    T_out[p, y[sel], z[sel]] = tn[sel]
                    dose[p, y[sel], z[sel]] = d[sel]
                    peak[p, y[sel], z[sel]] = pk[sel]
                    writes[p, y[sel], z[sel]] += 1
            assert not read & wrote, (m, read & wrote)  # no race in a step
    assert (writes == 1).all()  # every cell written once, by its owner
    return T_out, dose, peak


@pytest.mark.parametrize("shape, K, blocks", [
    ((27, 45, 47), 1, 64), ((27, 45, 47), 3, 64), ((27, 45, 47), 8, 64),
    ((5, 45, 47), 8, 1024),   # N1 < K
    ((12, 5, 20), 3, 1024),   # N2, N3 below one tile
    ((12, 5, 20), 6, 2),      # one x-segment
    ((40, 20, 70), 4, 200),   # segments of one plane
])
def test_kernel_march_equals_the_plain_steps(shape, K, blocks, monkeypatch):
    monkeypatch.setattr(BK, "FUSED_BLOCKS", blocks)
    rng = np.random.default_rng(12)
    mats, idx, _ = _setup(shape)
    idx[:] = rng.integers(0, 5, shape)
    co = T.make_bhte_coeffs(T._build_coeff_maps(idx, mats, DX, DT), "cpu")
    T0 = (37.0 + 8.0 * rng.random(shape)).astype(np.float32)
    q = (rng.random(shape) * 4e6).astype(np.float32)
    dose0 = rng.random(shape).astype(np.float32)
    peak0 = np.full(shape, -1e9, np.float32)
    cn = [c.numpy() for c in co.k6] + [co.irc.numpy(), co.perf.numpy()]
    for qq in (q, None):
        Te, de, pe = march(T0, dose0, peak0, cn, qq, 37.0, K)
        Tt, dt_, pt = (torch.tensor(a) for a in (T0, dose0, peak0))
        out = BK.bhte_fused(Tt, dt_, pt, co,
                            None if qq is None else torch.tensor(qq), 37.0, K)
        np.testing.assert_array_equal(Te, out.numpy())
        np.testing.assert_array_equal(pe, pt.numpy())
        np.testing.assert_allclose(de, dt_.numpy(), rtol=1e-6)
        assert (pe > 43.0).any() and (pe < 43.0).any()
