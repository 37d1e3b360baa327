"""Port parity: the x decomposition of ``babelbrain_tpu_torch`` on the CPU.

Twins of `tests/test_sharded.py` on meshes of CPU devices
(``make_mesh(n, devices=["cpu"] * n)``): a sharded ``run_fdtd`` must equal
the port's unsharded run bit for bit (fluid and shear media; plane, point
and volumetric sources; reflector twins; maps and monitors), and is held
to the JAX package's sharded runs on the conftest's 8 CPU devices: its XLA
path at the bands `tests/test_torch_fdtd.py` holds unsharded (plane 1e-4
of the peak with rtol 1e-3, point 1e-6, volumetric 1e-5), and its sharded
Pallas drivers B4 / B8 in interpret mode (the configurations of
`tests/test_sharded.py:327, :388`, whose x-CPML shift ``edge_offset`` the
port's edge ownership replaces) at 1e-5 of the peak, the band of B2 in
`tests/test_torch_fdtd.py`. Then the refusals, ``rayleigh_field(mesh=)``,
``run_fdtd_batch`` on a case mesh, ``run_multipoint(mesh=)`` and its
fan-out rule, ``make_mesh`` and the plain versions' x-slab flags. The
shapes are those of `tests/test_sharded.py`, with fewer cycles where the
port runs many meshes.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PS

from babelbrain_tpu.ops import fdtd as J
from babelbrain_tpu.ops import fdtd_pallas as JP
from babelbrain_tpu.ops.rayleigh import rayleigh_field as j_rayleigh_field
from babelbrain_tpu.parallel.halo import DomainComm
from babelbrain_tpu.parallel.halo import make_mesh as j_make_mesh
from babelbrain_tpu.tx import make_focused_bowl
from babelbrain_tpu_torch.ops import fdtd as T
from babelbrain_tpu_torch.ops import fdtd_kernels as K
from babelbrain_tpu_torch.ops import fdtd_visco_kernels as V
from babelbrain_tpu_torch.ops.rayleigh import rayleigh_field
from babelbrain_tpu_torch.parallel import halo as H
from babelbrain_tpu_torch.pipeline import acoustic as TA

torch.set_num_threads(2)

F0, C = 500e3, 1500.0
SHEAR = [[1000.0, C, 0, 0, 0], [1896.5, 2494.0, 1594.0, 106.0, 214.0]]


def cpu_mesh(n, axis="x"):
    return H.make_mesh(n, axis, devices=["cpu"] * n)


def _grid(shape, n_cycles, npml=12, **kw):
    """`tests/test_sharded.py`'s grid, as keyword arguments of FDTDGrid."""
    dx = C / F0 / 9
    ppp = int(np.ceil(1 / F0 / J.stable_dt(dx, 2494.0, cfl=0.9)))
    dt = 1 / F0 / ppp
    nsteps = ppp * n_cycles
    return dict(shape=shape, dx=dx, dt=dt, n_steps=nsteps, frequency=F0,
                npml=npml, sensor_start=nsteps - 2 * ppp,
                source_plane_z=npml + 1, **kw)


def _equal(a, b, keys=None):
    for k in keys or a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


@functools.cache
def _slab_case():
    """`tests/test_sharded.py:31`: a shear slab at (128, 48, 80), with its
    port run unsharded (2 cycles)."""
    shape = (128, 48, 80)
    g = _grid(shape, 2)
    mats = np.array(SHEAR)
    idx = np.zeros(shape, np.uint8)
    idx[:, :, 40:50] = 1
    rng = np.random.default_rng(0)
    amp = np.zeros(shape[:2])
    amp[16:-16, 16:-16] = 60e3 * rng.uniform(0.5, 1, (96, 16))
    ph = rng.uniform(-3, 3, shape[:2])
    kw = dict(source_amp=amp, source_phase=ph)
    o1 = T.run_fdtd(idx, mats, T.FDTDGrid(**g), device="cpu", **kw)
    return idx, mats, g, kw, o1


@functools.cache
def _slab_sharded(n):
    idx, mats, g, kw, _ = _slab_case()
    return T.run_fdtd(idx, mats, T.FDTDGrid(**g), mesh=cpu_mesh(n), **kw)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_shear_slab_sharded_bit_equal(n):
    """`tests/test_sharded.py:46, :57` twin: 2, 4 and 8 shards of the
    viscoelastic slab equal the unsharded run bit for bit."""
    o1 = _slab_case()[-1]
    assert np.isfinite(o1["p_amp"]).all() and o1["p_amp"].max() > 0
    _equal(o1, _slab_sharded(n))


@functools.cache
def _fluid_case():
    """`tests/test_sharded.py:155`'s fluid configuration at (128, 32, 48),
    4 cycles, with attenuation, and its port run unsharded."""
    shape = (128, 32, 48)
    g = _grid(shape, 4)
    mats = np.array([[1000.0, C, 0.0, 20.0, 0.0]])
    idx = np.zeros(shape, np.uint8)
    rng = np.random.default_rng(3)
    amp = np.zeros(shape[:2], np.float32)
    amp[10:-10, 10:22] = 60e3 * rng.uniform(0.5, 1, (108, 12))
    ph = rng.uniform(-2, 2, shape[:2]).astype(np.float32)
    kw = dict(source_amp=amp, source_phase=ph)
    o1 = T.run_fdtd(idx, mats, T.FDTDGrid(**g), device="cpu", **kw)
    return idx, mats, g, kw, o1


@pytest.mark.parametrize("n", [2, 4, 8])
def test_fluid_sharded_bit_equal(n):
    idx, mats, g, kw, o1 = _fluid_case()
    on = T.run_fdtd(idx, mats, T.FDTDGrid(**g), mesh=cpu_mesh(n), **kw)
    _equal(o1, on)


def _point_case(shear):
    """`tests/test_sharded.py:256` twin: a stress point owned by the third
    of four shards at (64, 32, 48), npml 4; in shear media over a slab."""
    shape = (64, 32, 48)
    g = _grid(shape, 3, npml=4, source_type="stress_point",
              source_ijk=(33, 16, 24))
    g["source_plane_z"] = 5
    mats = np.array(SHEAR if shear else SHEAR[:1])
    idx = np.zeros(shape, np.uint8)
    if shear:
        idx[:, :, 28:36] = 1
    return idx, mats, g


@functools.cache
def _point_runs(shear):
    """The point case unsharded and on 4 shards."""
    idx, mats, g = _point_case(shear)
    return [T.run_fdtd(idx, mats, T.FDTDGrid(**g), point_amp=60e3, **kw)
            for kw in (dict(device="cpu"), dict(mesh=cpu_mesh(4)))]


@pytest.mark.parametrize("shear", [False, True])
def test_point_source_on_an_inner_shard_bit_equal(shear):
    o1, o4 = _point_runs(shear)
    assert o1["p_amp"].max() > 0
    _equal(o1, o4)


def _shell_source(shape, centre, seed=7):
    """The dome shell of `tests/test_sharded.py:179` (phased), a dense
    dict; its voxels span several shards."""
    ci, cj, ck = centre
    ii, jj, kk = np.mgrid[:shape[0], :shape[1], :shape[2]]
    r = np.sqrt((ii - ci) ** 2 + (jj - cj) ** 2 + (kk - ck) ** 2)
    shell = (r > 9) & (r < 11) & (kk < ck)
    rng = np.random.default_rng(seed)
    rr = np.maximum(r, 1e-6)
    return dict(amp=np.where(shell, 60e3, 0.0).astype(np.float32),
                phase=(rng.uniform(-2, 2, shape) * shell).astype(np.float32),
                ox=((ci - ii) / rr).astype(np.float32),
                oy=((cj - jj) / rr).astype(np.float32),
                oz=((ck - kk) / rr).astype(np.float32))


def _volume_case(shear):
    shape = (64, 32, 48)
    g = _grid(shape, 3, source_type="velocity_volume")
    mats = (np.array(SHEAR) if shear else
            np.array([[1000.0, C, 0.0, 20.0, 0.0],
                      [1896.0, 2494.0, 0.0, 150.0, 0.0]]))
    idx = np.zeros(shape, np.uint8)
    idx[:, :, 28:34] = 1
    return idx, mats, g, _shell_source(shape, (32.0, 16.0, 20.0))


@functools.cache
def _volume_runs(shear):
    """The volumetric case unsharded and on 4 shards."""
    idx, mats, g, vs = _volume_case(shear)
    return [T.run_fdtd(idx, mats, T.FDTDGrid(**g), volume_source=vs, **kw)
            for kw in (dict(device="cpu"), dict(mesh=cpu_mesh(4)))]


@pytest.mark.parametrize("shear", [False, True])
def test_volume_source_sharded_bit_equal(shear):
    """The sparse scatter split over 4 shards and re-indexed."""
    o1, o4 = _volume_runs(shear)
    assert o1["p_amp"].max() > 0
    _equal(o1, o4)


def test_reflector_sharded_bit_equal():
    """`tests/test_sharded.py:495` twin (fluid, air pocket across shards)."""
    idx, mats, g, kw, o1 = _fluid_case()
    g = dict(g, n_steps=g["n_steps"] * 3 // 4,
             sensor_start=g["sensor_start"] * 3 // 4)
    refl = np.zeros(g["shape"], bool)
    refl[40:90, 8:24, 30:34] = True
    kw = dict(kw, reflector_mask=refl)
    o1 = T.run_fdtd(idx, mats, T.FDTDGrid(**g), device="cpu", **kw)
    o4 = T.run_fdtd(idx, mats, T.FDTDGrid(**g), mesh=cpu_mesh(4), **kw)
    assert o1["p_amp"].max() > 0 and o4["p_amp"][refl].max() == 0.0
    _equal(o1, o4)


MAPS = ("Pressure_rms", "Vz_peak", "Sigmaxx_rms", "Vx_peak")
MONITORS = np.array([[13, 15, 30], [40, 16, 36], [60, 20, 26], [31, 2, 40],
                     [32, 2, 40], [40, 16, 36]])


def _maps_case(shear):
    """`tests/test_sharded.py:470`: maps and monitors (on shard edges,
    one repeated) at (64, 32, 48), every second window step."""
    shape = (64, 32, 48)
    g = _grid(shape, 3)
    mats = (np.array(SHEAR) if shear
            else np.array([[1000.0, C, 0.0, 20.0, 0.0]]))
    idx = np.zeros(shape, np.uint8)
    if shear:
        idx[:, :, 28:36] = 1
    amp = np.zeros(shape[:2], np.float32)
    amp[10:-10, 10:22] = 60e3
    kw = dict(source_amp=amp, sel_maps=MAPS, monitor_ijk=MONITORS,
              sensor_subsampling=2)
    return idx, mats, g, kw


@functools.cache
def _maps_runs(shear):
    """The maps case unsharded and on 4 shards."""
    idx, mats, g, kw = _maps_case(shear)
    return [T.run_fdtd(idx, mats, T.FDTDGrid(**g), **kw, **where)
            for where in (dict(device="cpu"), dict(mesh=cpu_mesh(4)))]


@pytest.mark.parametrize("shear", [False, True])
def test_maps_and_monitors_sharded_bit_equal(shear):
    o1, o4 = _maps_runs(shear)
    assert o1["sensor_series"].shape == (len(MONITORS),
                                         len(o1["sensor_times"]))
    _equal(o1, o4)


# ---------------------------------------------------------------------------
# against the JAX package's sharded runs
# ---------------------------------------------------------------------------


def _band(ot, oj, band, rtol=0.0, keys=("p_amp", "peak")):
    for k in keys:
        scale = oj[k].max()
        assert scale > 0
        np.testing.assert_allclose(ot[k], oj[k], atol=band * scale,
                                   rtol=rtol, err_msg=k)


def test_shear_slab_matches_jax_xla_sharded():
    """8 shards of the slab against JAX's 8-device XLA run, at the visco
    plane band."""
    idx, mats, g, kw, _ = _slab_case()
    oj = J.run_fdtd(idx, mats, J.FDTDGrid(**g), mesh=j_make_mesh(8),
                    backend="xla", **kw)
    _band(_slab_sharded(8), oj, 1e-4, rtol=1e-3)


def test_point_and_maps_match_jax_xla_sharded():
    """4 shards against JAX's 4-device XLA run: the inner-shard stress
    point (point band) and the fluid maps and monitors (plane band)."""
    idx, mats, g = _point_case(False)
    oj = J.run_fdtd(idx, mats, J.FDTDGrid(**g), point_amp=60e3,
                    mesh=j_make_mesh(4), backend="xla")
    _band(_point_runs(False)[1], oj, 1e-6)
    idx, mats, g, kw = _maps_case(False)
    oj = J.run_fdtd(idx, mats, J.FDTDGrid(**g), mesh=j_make_mesh(4),
                    backend="xla", **kw)
    ot = _maps_runs(False)[1]
    _band(ot, oj, 1e-4, rtol=1e-3, keys=MAPS + ("p_amp",))
    np.testing.assert_allclose(ot["sensor_series"], oj["sensor_series"],
                               atol=1e-4 * np.abs(oj["sensor_series"]).max(),
                               rtol=1e-3)
    np.testing.assert_array_equal(ot["sensor_times"], oj["sensor_times"])


def test_volume_source_matches_jax_xla_sharded():
    idx, mats, g, vs = _volume_case(False)
    oj = J.run_fdtd(idx, mats, J.FDTDGrid(**g), volume_source=vs,
                    mesh=j_make_mesh(4), backend="xla")
    _band(_volume_runs(False)[1], oj, 1e-5)


def _pallas_sharded(fn, props, args, g, n=4):
    """The JAX Pallas driver ``fn`` sharded over n CPU devices in interpret
    mode (`tests/test_sharded.py:327`)."""
    grid_local = dataclasses.replace(
        J.FDTDGrid(**g), shape=(g["shape"][0] // n,) + g["shape"][1:])
    spec3, spec2 = PS("x", None, None), PS("x", None)
    scalars = (PS(),) * (len(args) - 2)
    run = jax.jit(jax.shard_map(
        functools.partial(fn, grid=grid_local, comm=DomainComm("x", n),
                          interpret=True),
        mesh=j_make_mesh(n),
        in_specs=({k: spec3 for k in props}, spec2, spec2) + scalars,
        out_specs=(spec3, spec3, spec3), check_vma=False,
    ))
    acc_c, acc_s, peak = (np.asarray(o) for o in run(props, *args))
    n_win = g["n_steps"] - g["sensor_start"]
    return {"p_amp": 2.0 / n_win * np.sqrt(acc_c**2 + acc_s**2),
            "peak": peak}


@pytest.mark.parametrize("family", ["fluid", "visco"])
def test_edge_ownership_matches_jax_pallas_sharded(family):
    """The port's x-CPML edge ownership against B4's / B8's ``edge_offset``:
    the sharded fusedK drivers of `tests/test_sharded.py:327, :388` (4
    shards, interpret mode; 2 cycles) against the port on the same 4-shard
    mesh."""
    shape = (128, 32, 48)
    if family == "fluid":
        g = _grid(shape, 2)
        mats = np.array([[1000.0, C, 0.0, 20.0, 0.0]])
        idx = np.zeros(shape, np.uint8)
        seed, cmax, depth = 3, C, 3
    else:
        g = _grid(shape, 2)
        mats = np.array([[1000.0, C, 0, 20.0, 0], SHEAR[1]])
        idx = np.zeros(shape, np.uint8)
        idx[:, :, 28:36] = 1
        seed, cmax, depth = 5, 2494.0, 2
    rng = np.random.default_rng(seed)
    amp = np.zeros(shape[:2], np.float32)
    amp[10:-10, 10:22] = 60e3 * rng.uniform(0.5, 1, (108, 12)).astype(
        np.float32)
    ph = rng.uniform(-2, 2, shape[:2]).astype(np.float32)
    coefs = J.sls_coefficients(mats, F0, g["dt"])
    props = {k: jnp.asarray(v) for k, v in J._material_fields(
        idx, coefs, has_shear=family == "visco").items()}
    prof = J._build_cpml_profiles_np(shape, 12, g["dx"], g["dt"], cmax, 1e-5)
    kw = dict(profiles_np=prof, viscous=True, oz_scale=1.0 / (1000.0 * C),
              nb=2, fuse_steps=depth)
    if family == "fluid":
        oj = _pallas_sharded(
            functools.partial(JP.simulate_fluid_pallas, **kw), props,
            (jnp.asarray(amp), jnp.asarray(ph)), g)
    else:
        oj = _pallas_sharded(
            functools.partial(JP.simulate_visco_pallas, **kw), props,
            (jnp.asarray(amp), jnp.asarray(ph), jnp.float32(0.0)), g)
    ot = T.run_fdtd(idx, mats, T.FDTDGrid(**g), source_amp=amp,
                    source_phase=ph, mesh=cpu_mesh(4))
    _band(ot, oj, 1e-5)


# ---------------------------------------------------------------------------
# refusals and meshes
# ---------------------------------------------------------------------------


def test_shard_constraints_raise():
    """`tests/test_sharded.py:284` twin, with JAX's messages: N1 not
    divisible by the mesh, a shard thinner than npml + 2, a mesh on
    another axis than x and a 2-D mesh."""
    mats = np.array(SHEAR)
    g = _grid((126, 48, 80), 1)
    idx = np.zeros(g["shape"], np.uint8)
    amp = np.zeros(g["shape"][:2])
    with pytest.raises(ValueError, match=r"not divisible by mesh \(8, 1\)"):
        T.run_fdtd(idx, mats, T.FDTDGrid(**g), source_amp=amp,
                   mesh=cpu_mesh(8))
    with pytest.raises(ValueError, match="shard too thin for the PML slab"):
        T.run_fdtd(idx, mats, T.FDTDGrid(**g), source_amp=amp,
                   mesh=cpu_mesh(14))
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        T.run_fdtd(idx, mats, T.FDTDGrid(**g), source_amp=amp,
                   mesh=cpu_mesh(2, axis="case"))
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        T.run_fdtd(idx, mats, T.FDTDGrid(**g), source_amp=amp,
                   mesh=H.make_mesh_2d(1, 2, devices=["cpu"] * 2))


def test_make_mesh_names_only_devices_that_exist(monkeypatch):
    """Without ``devices`` a mesh takes CUDA devices 0..n-1 and refuses
    more than exist (none here: no CPU fallback); a named CUDA device must
    exist; named devices may repeat."""
    n_cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match="CUDA devices asked for"):
        H.make_mesh(n_cards + 1)
    if n_cards == 0:
        with pytest.raises(ValueError, match="CUDA devices asked for"):
            H.make_mesh()
    with pytest.raises(ValueError, match="not a CUDA device"):
        H.make_mesh(devices=[f"cuda:{n_cards}"])
    with pytest.raises(ValueError, match="2 devices asked for, 3 named"):
        H.make_mesh(2, devices=["cpu"] * 3)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = H.make_mesh()
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert mesh.axis_names == ("x",) and mesh.shape == (2,)
    m2 = H.make_mesh_2d(2, 3, devices=["cpu"] * 6)
    assert H.mesh_axis_sizes(m2) == (2, 3) and m2.size == 6
    assert H.mesh_axis_sizes(T.make_case_mesh(devices=["cpu"])) == (1, 1)


def test_x_slabs_refresh_ghost_planes():
    """Each shard's ghost planes take its neighbours' own planes; the
    global edges have none."""
    xs = H.XSlabs(24, 3)
    assert [xs.start(s) for s in range(3)] == [0, 6, 14]
    assert [xs.planes(s) for s in range(3)] == [10, 12, 10]
    full = torch.arange(24.0).reshape(24, 1)
    parts = [torch.full((xs.planes(s), 1), -1.0) for s in range(3)]
    for s, p in enumerate(parts):
        p[xs.own(s)] = full[s * 8:(s + 1) * 8]
    xs.refresh(parts)
    for s, p in enumerate(parts):
        a = xs.start(s)
        assert torch.equal(p, full[a:a + xs.planes(s)])


# ---------------------------------------------------------------------------
# the plain versions' x-slab flags
# ---------------------------------------------------------------------------


def _old_cpml(D, axis, prof, psi_lo, psi_hi):
    """``_cpml`` as it was before the x-slab flags (both slabs, always)."""
    ns = prof.shape[-1]
    shape = [1, 1, 1]
    shape[axis] = ns
    b_lo, a_lo, b_hi, a_hi = (prof[q].reshape(shape) for q in range(4))
    d_lo = D.narrow(axis, 0, ns)
    new_lo = b_lo * psi_lo + a_lo * d_lo
    psi_lo.copy_(new_lo)
    d_lo.copy_(d_lo + new_lo)
    d_hi = D.narrow(axis, D.shape[axis] - ns, ns)
    new_hi = b_hi * psi_hi + a_hi * d_hi
    psi_hi.copy_(new_hi)
    d_hi.copy_(d_hi + new_hi)
    return D


def _psi_x(st):
    """The x-slab psi tensors of a state, as (lo list, hi list)."""
    if isinstance(st, K.FluidState):
        pairs = [(st.psi_p, 0), (st.psi_v, 0)]
    else:
        pairs = [(psi, q) for psi, derivs in ((st.psi_s, V.VELOCITY_DERIVS),
                                              (st.psi_v, V.STRESS_DERIVS))
                 for q, d in enumerate(derivs) if d[1] == 0]
    return ([psi[2 * q] for psi, q in pairs],
            [psi[2 * q + 1] for psi, q in pairs])


@pytest.mark.parametrize("family", ["fluid", "visco"])
def test_plain_x_slab_flags(family, monkeypatch):
    """Both flags on (a whole grid) is the step as it was; an interior
    shard (both off) leaves its x psi slabs at zero; a first shard (lo
    only) its hi slabs."""
    shape = (36, 24, 32)
    g = T.FDTDGrid(**_grid(shape, 1, npml=6))
    mats = np.array(SHEAR if family == "visco" else SHEAR[:1])
    idx = np.zeros(shape, np.uint8)
    idx[:, :, 20:24] = len(mats) - 1
    amp = np.zeros(shape[:2])
    amp[4:-4, 4:-4] = 60e3
    runs = {}
    for name, flags in (("old", None), ("both", (True, True)),
                        ("lo", (True, False)), ("none", (False, False))):
        step, st, co, oz, _ = T.fdtd_setup(idx, mats, g, amp, amp * 0.1,
                                           device="cpu")
        with monkeypatch.context() as m:
            if flags is None:
                for mod in (K, V):
                    m.setattr(mod, "_cpml", lambda *a, **flags: _old_cpml(*a))
            else:
                co.x_lo, co.x_hi = flags
            for n in range(40):
                step(st, co, g, n, oz)
        runs[name] = st
    old, both = runs["old"], runs["both"]
    for k, v in vars(old).items():
        for a, b in zip(v if isinstance(v, list) else [v],
                        (getattr(both, k) if isinstance(v, list)
                         else [getattr(both, k)])):
            assert torch.equal(a, b), k
    lo, hi = _psi_x(runs["none"])
    assert all(not t.any() for t in lo + hi)
    lo, hi = _psi_x(runs["lo"])
    assert any(t.any() for t in lo) and not any(t.any() for t in hi)
    lo, hi = _psi_x(both)
    assert any(t.any() for t in lo) and any(t.any() for t in hi)


# ---------------------------------------------------------------------------
# Rayleigh points, cases and multipoint over meshes
# ---------------------------------------------------------------------------


def test_rayleigh_point_sharded_matches_single_device():
    """`tests/test_rayleigh.py:207` twin: 1001 points over 8 devices within
    JAX's band (2e-5 of the peak); with a point block that splits them in
    whole blocks per device, bit-equal; and against JAX's 8-device run."""
    k0 = 2 * np.pi * F0 / C
    tx = make_focused_bowl(F0, 63.2e-3, 64e-3, C)
    rng = np.random.default_rng(7)
    u0 = (rng.uniform(0.5, 1, tx.num_subelements)
          * np.exp(1j * rng.uniform(-3, 3, tx.num_subelements))
          ).astype(np.complex64) * 60e3
    pts = rng.uniform(-30e-3, 30e-3, (1001, 3)).astype(np.float32)
    args = (k0, tx.centers, tx.areas, u0, pts)
    p1 = rayleigh_field(*args, device="cpu")
    p8 = rayleigh_field(*args, mesh=cpu_mesh(8))
    scale = np.abs(p1).max()
    np.testing.assert_allclose(p8 / scale, p1 / scale, atol=2e-5)
    np.testing.assert_array_equal(
        rayleigh_field(*args, point_block=64, mesh=cpu_mesh(8)),
        rayleigh_field(*args, point_block=64, device="cpu"))
    pj = np.asarray(j_rayleigh_field(*args, mesh=j_make_mesh(8)))
    np.testing.assert_allclose(p8 / scale, pj / scale, atol=2e-5)


def test_run_fdtd_batch_on_a_case_mesh():
    """`tests/test_benchmark_multipoint.py:137` twin: 3 cases over a 2-device
    case mesh, each equal to ``run_fdtd`` of its plane bit for bit, and
    held to JAX's case-mesh batch at its band (1e-6 of each case's peak)."""
    shape = (48, 48, 64)
    dx = C / F0 / 6
    ppp = int(np.ceil(1 / F0 / J.stable_dt(dx, 2400.0, cfl=0.9)))
    nsteps = ppp * 4
    g = dict(shape=shape, dx=dx, dt=1 / F0 / ppp, n_steps=nsteps,
             frequency=F0, npml=10, sensor_start=nsteps - 2 * ppp,
             source_plane_z=11)
    mats = np.array([[1000.0, C, 0, 0, 0], [1850.0, 2400.0, 0, 150.0, 0]])
    idx = np.zeros(shape, np.uint8)
    idx[:, :, 36:42] = 1
    rng = np.random.default_rng(3)
    amps = np.zeros((3,) + shape[:2], np.float32)
    amps[:, 14:-14, 14:-14] = 60e3 * rng.uniform(0.3, 1, (3, 20, 20))
    phases = rng.uniform(-3, 3, (3,) + shape[:2]).astype(np.float32)
    mesh = T.make_case_mesh(devices=["cpu"] * 2)
    batch = T.run_fdtd_batch(idx, mats, T.FDTDGrid(**g), amps, phases,
                             mesh=mesh)
    bj = J.run_fdtd_batch(idx, mats, J.FDTDGrid(**g), amps, phases,
                          mesh=J.make_case_mesh())
    for b in range(3):
        single = T.run_fdtd(idx, mats, T.FDTDGrid(**g), source_amp=amps[b],
                            source_phase=phases[b], device="cpu")
        _equal(single, {k: v[b] for k, v in batch.items()})
        scale = bj["p_amp"][b].max()
        np.testing.assert_allclose(batch["p_amp"][b] / scale,
                                   bj["p_amp"][b] / scale, atol=1e-6)


def test_run_multipoint_over_a_mesh_and_the_fanout_rule(monkeypatch):
    """Each point's FDTD over a 2-shard mesh equals the unsharded run; the
    fan-out rule is JAX's: several cards, no spatial mesh, no refocusing,
    more than one target."""
    from babelbrain_tpu_torch.pipeline import domain as TD
    from babelbrain_tpu_torch.tx import make_annular_array

    mask = np.zeros((24, 24, 40), np.uint8)
    mask[6:18, 6:18, 10:30] = 4
    mask[12, 12, 20] = 5
    mats = TD.build_label_materials(500e3, False)[:1]
    dom = TD.build_domain(mask, 500e3, 6.0, materials=mats, water_only=True)
    F = 62.94e-3
    tx = make_annular_array(
        500e3, F, [0.0, 31.6988e-3, 44.2688e-3, 53.6688e-3],
        [31.14e-3, 43.71e-3, 53.11e-3, 60.83e-3], 1500.0, ppw_surface=1.0,
    ).translated([0, 0, F])
    tx = TA.position_transducer(tx, dom, F)
    points = [[0, 0, -4e-3], [0, 0, 4e-3]]
    n1 = dom.material_map.shape[0]
    assert n1 % 2 == 0 and n1 // 2 >= dom.npml + 2
    rs, cs = TA.run_multipoint(dom, tx, points, fanout=False, device="cpu")
    rm, cm = TA.run_multipoint(dom, tx, points, mesh=cpu_mesh(2),
                               device="cpu")
    for a, b in zip(rs, rm):
        for k in ("p_amp", "p_complex_re", "p_complex_im"):
            np.testing.assert_array_equal(b.data_for_sim[k],
                                          a.data_for_sim[k], err_msg=k)
    np.testing.assert_array_equal(cm["p_amp_all"], cs["p_amp_all"])

    rule = TA.fanout_mesh
    assert rule("auto", None, False, 2, "cpu") == (False, None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    use, mesh = rule("auto", None, False, 3, "cuda")
    assert use and mesh.devices == (torch.device("cuda", 0),
                                    torch.device("cuda", 1))
    assert mesh.axis_names == ("case",)
    assert rule("auto", cpu_mesh(2), False, 3, "cuda") == (False, None)
    assert rule("auto", None, True, 3, "cuda") == (False, None)
    assert rule("auto", None, False, 1, "cuda") == (False, None)
    assert rule(False, None, False, 3, "cuda") == (False, None)
    assert rule(True, None, True, 1, "cuda") == (True, None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert rule("auto", None, False, 3, "cuda") == (False, None)
    assert rule(True, None, False, 3, "cuda") == (True, None)


def test_profile_dir_writes_a_trace(tmp_path, monkeypatch):
    """``BBT_PROFILE_DIR``: the outermost span writes a torch.profiler trace
    there, with the inner spans as ranges."""
    import json

    from babelbrain_tpu_torch.utils import timing

    monkeypatch.setenv("BBT_PROFILE_DIR", str(tmp_path))
    with timing.stage_timer("outer", quiet=True):
        with timing.stage_timer("inner", level=3, quiet=True):
            torch.ones(64).cumsum(0)
    traces = list(tmp_path.glob("*.json"))
    assert len(traces) == 1, traces
    names = {e.get("name") for e in json.loads(traces[0].read_text())
             ["traceEvents"]}
    assert "CTS:L3: inner" in names, sorted(n for n in names if n)
