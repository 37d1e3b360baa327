"""The port's copies of the JAX package's Step-1 host modules, and the two
new morphology ops, give JAX's results bit for bit.

On the inputs of `tests/test_mesh.py`, `test_voxelize.py`,
`test_simnibs.py` and `test_plantus.py` (and of `tests/test_pipeline.py`'s
bias correction and `test_cli.py`'s trajectory files): ``transforms``,
``bias``, ``simnibs``, ``ops.mesh``, ``ops.voxelize`` with its native and
NumPy backends, ``gifti`` and ``plantus``; ``imaging.binary_open`` and
``binary_dilate`` against JAX's; Step 1's ``export_surface_meshes`` and
``create_target_mask``.
"""

import dataclasses

import numpy as np
import pytest

from babelbrain_tpu import native as JN
from babelbrain_tpu.ops import imaging as JI
from babelbrain_tpu.ops import mesh as JM
from babelbrain_tpu.ops import voxelize as JV
from babelbrain_tpu.pipeline import bias as JB
from babelbrain_tpu.pipeline import gifti as JG
from babelbrain_tpu.pipeline import plantus as JPL
from babelbrain_tpu.pipeline import simnibs as JSN
from babelbrain_tpu.pipeline import step1 as JS1
from babelbrain_tpu.pipeline import transforms as JTF
from babelbrain_tpu_torch import native as TN
from babelbrain_tpu_torch.ops import imaging as TI
from babelbrain_tpu_torch.ops import mesh as TM
from babelbrain_tpu_torch.ops import voxelize as TV
from babelbrain_tpu_torch.pipeline import bias as TB
from babelbrain_tpu_torch.pipeline import gifti as TG
from babelbrain_tpu_torch.pipeline import plantus as TPL
from babelbrain_tpu_torch.pipeline import simnibs as TSN
from babelbrain_tpu_torch.pipeline import step1 as TS1
from babelbrain_tpu_torch.pipeline import transforms as TTF
from test_simnibs import _box_mesh, _write_ascii, _write_binary


def _equal(a, b):
    """Equal structure and arrays, bit for bit (NaN where NaN)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _same_file(pa, pb):
    with open(pa, "rb") as fa, open(pb, "rb") as fb:
        assert fa.read() == fb.read()


# ---------------------------------------------------------------------------
# transforms, bias, simnibs
# ---------------------------------------------------------------------------


def test_trajectory_and_tfm_io_match_jax(tmp_path):
    m = np.eye(4)
    m[:3, :3] = JS1.trajectory_frame(np.array([12.0, -8.0, 55.0]),
                                     np.array([0.2, -0.1, -1.0]))
    m[:3, 3] = [12.0, -8.0, 55.0]
    for name, mod in (("j", JTF), ("t", TTF)):
        mod.write_trajectory_brainsight(str(tmp_path / f"{name}.txt"),
                                        "Target1", m)
        mod.write_itk_tfm(str(tmp_path / f"{name}.tfm"), m)
    for ext in ("txt", "tfm"):
        _same_file(tmp_path / f"j.{ext}", tmp_path / f"t.{ext}")
    p = str(tmp_path / "j.txt")
    _equal(TTF.read_trajectory_brainsight(p), JTF.read_trajectory_brainsight(p))
    _equal(TTF.read_itk_tfm(str(tmp_path / "j.tfm")),
           JTF.read_itk_tfm(str(tmp_path / "j.tfm")))
    _equal(TTF.trajectory_target_direction(m),
           JTF.trajectory_target_direction(m))


@pytest.mark.parametrize("basis", ["poly", "bspline"])
def test_bias_correction_matches_jax(basis):
    """The shaded-sphere input of `tests/test_pipeline.py:530`."""
    rng = np.random.default_rng(1234)
    n = 40
    ii, jj, kk = np.mgrid[0:n, 0:n, 0:n].astype(float) / (n - 1)
    r = np.sqrt((ii - 0.5) ** 2 + (jj - 0.5) ** 2 + (kk - 0.5) ** 2)
    mask = r < 0.4
    truth = np.where(mask, 1000.0, 10.0)
    truth[(r > 0.25) & (r < 0.32)] = 400.0
    bias = np.exp(0.8 * (ii - 0.5) + 0.5 * (jj - 0.5) ** 2)
    meas = truth * bias * (1 + 0.01 * rng.normal(size=truth.shape))
    _equal(TB.correct_bias_field(meas, mask, basis=basis),
           JB.correct_bias_field(meas, mask, basis=basis))


@pytest.mark.parametrize("writer", [_write_ascii, _write_binary],
                         ids=["ascii", "binary"])
def test_simnibs_matches_jax(tmp_path, writer):
    nodes, tets, tags = _box_mesh()
    p = str(tmp_path / "head.msh")
    writer(p, nodes, tets, tags)
    _equal(TSN.read_msh(p), JSN.read_msh(p))
    for aff, shape in ((np.eye(4), (10, 10, 10)),
                       (np.diag([0.5, 0.5, 0.5, 1.0]), (20, 20, 20))):
        _equal(TSN.rasterize_tetrahedra(nodes, tets, tags, aff, shape),
               JSN.rasterize_tetrahedra(nodes, tets, tags, aff, shape))
    _equal(TSN.msh_to_labels(p, np.eye(4), (10, 10, 10)),
           JSN.msh_to_labels(p, np.eye(4), (10, 10, 10)))
    assert TSN.SIMNIBS_TO_CHARM == JSN.SIMNIBS_TO_CHARM


# ---------------------------------------------------------------------------
# meshes and voxelization
# ---------------------------------------------------------------------------


def _ball(n=48, r=16.0):
    g = np.arange(n)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    c = (n - 1) / 2
    return ((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2) <= r * r


def _mesh_case(mod, case):
    """One `tests/test_mesh.py` computation in module ``mod``."""
    if case == "marching_tetrahedra":
        tris = mod.marching_tetrahedra(_ball().astype(np.float64), 0.5)
        return tris, mod.mesh_volume(tris), mod.weld_vertices(tris)
    if case == "taubin_smooth":
        tris = mod.marching_tetrahedra(_ball(40, 13.0).astype(np.float64), 0.5)
        verts, faces = mod.weld_vertices(tris)
        sm = mod.taubin_smooth(verts, faces, iterations=20)
        return sm, mod.faces_to_triangles(sm, faces)
    if case == "mask_to_mesh":
        A = np.diag([0.5, 0.5, 0.5, 1.0])
        A[:3, 3] = [10.0, -4.0, 2.0]
        return (mod.mask_to_mesh(_ball(44, 14.0), smooth_iterations=8),
                mod.mask_to_mesh(_ball(32, 10.0), affine=A,
                                 smooth_iterations=4))
    if case == "cone_mesh":
        return mod.cone_mesh([0, 0, 0], [0, 0, 1], 30.0, 2.0, 12.0, n_seg=96)
    op = case.split("_", 1)[1]
    vox = JV if mod is JM else TV
    a = vox.sphere_mesh([0.0, 0, 0], 10.0, 3)
    b = vox.sphere_mesh([8.0, 0, 0], 10.0, 3)
    return mod.boolean_meshes(a, b, pitch=0.5, op=op)


@pytest.mark.parametrize("case", [
    "marching_tetrahedra", "taubin_smooth", "mask_to_mesh", "cone_mesh",
    "boolean_intersection", "boolean_union", "boolean_difference"])
def test_mesh_ops_match_jax(case):
    _equal(_mesh_case(TM, case), _mesh_case(JM, case))


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_voxelize_matches_jax(backend):
    """The inputs of `tests/test_voxelize.py`, on either backend; the native
    one is built from the port's own ``native/voxelize.cpp``."""
    if backend == "native":
        assert TN.native_available("voxelize") == JN.native_available(
            "voxelize")
        if not TN.native_available("voxelize"):
            pytest.skip("no C++ toolchain for the native voxelizer")
    cases = [
        (TV.sphere_mesh([20.0, 21.0, 19.0], 12.0, 3), [0, 0, 0], 1.0,
         (40, 42, 38)),
        (TV.sphere_mesh([10, 10, 10], 6.0, 3), [0, 0, 0], 0.75, (27, 27, 27)),
        (TV.sphere_mesh([20.0, 21.5, 23.0], 15.0, n_sub=4), [-2.3, 0.7, 1.1],
         0.8, (44, 46, 48)),
        (TV.sphere_mesh([50, 50, 50], 5.0, 2), [0, 0, 0], 1.0, (20, 20, 20)),
    ]
    for tris, origin, dx, shape in cases:
        out = TV.voxelize_solid(tris, origin, dx, shape, backend=backend)
        assert out.dtype == bool
        _equal(out, JV.voxelize_solid(tris, origin, dx, shape,
                                      backend="numpy"))


def test_sphere_mesh_and_stl_io_match_jax(tmp_path):
    for args in (([20.0, 21.0, 19.0], 12.0, 3), ([0, 0, 0], 3.0, 1)):
        _equal(TV.sphere_mesh(*args), JV.sphere_mesh(*args))
    tris = TV.sphere_mesh([0, 0, 0], 3.0, 1)
    TV.write_stl(str(tmp_path / "t.stl"), tris)
    JV.write_stl(str(tmp_path / "j.stl"), tris)
    _same_file(tmp_path / "t.stl", tmp_path / "j.stl")
    _equal(TV.read_stl(str(tmp_path / "j.stl")),
           JV.read_stl(str(tmp_path / "j.stl")))
    ascii_stl = tmp_path / "a.stl"
    ascii_stl.write_text(
        "solid t\nfacet normal 0 0 1\nouter loop\nvertex 0 0 0\n"
        "vertex 1 0 0\nvertex 0 1 0\nendloop\nendfacet\nendsolid t\n")
    _equal(TV.read_stl(str(ascii_stl)), JV.read_stl(str(ascii_stl)))


# ---------------------------------------------------------------------------
# morphology, Step-1 helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op,size", [("binary_open", 5), ("binary_open", 3),
                                     ("binary_dilate", 3),
                                     ("binary_dilate", 5)])
def test_binary_open_and_dilate_match_jax(op, size):
    rng = np.random.default_rng(7)
    vol = rng.random((23, 26, 29)) < 0.35
    vol[4:18, 5:20, 6:22] |= True  # a solid block that opening keeps
    out = getattr(TI, op)(vol, size, device="cpu")
    assert out.dtype == bool
    _equal(out, getattr(JI, op)(vol, size))


def test_export_surface_meshes_and_target_mask_match_jax(tmp_path):
    from babelbrain_tpu.pipeline.io import save_nifti

    n = 40
    lab = np.zeros((n, n, n), np.uint8)
    r = np.linalg.norm(np.indices(lab.shape) - 19.5, axis=0)
    lab[r < 18] = 1
    lab[r < 15] = 2
    lab[r < 12] = 4
    aff = np.diag([2.0, 2.0, 2.0, 1.0])
    aff[:3, 3] = -40.0
    kw = dict(mask=lab, affine=aff, dx_mm=2.0, target_idx=np.array([20, 20, 20]))
    files = {}
    for name, mod in (("j", JS1), ("t", TS1)):
        files[name] = mod.export_surface_meshes(mod.Step1Result(**kw),
                                                str(tmp_path / name))
    assert sorted(files["j"]) == sorted(files["t"]) == ["bone", "csf", "skin"]
    for k in files["j"]:
        _same_file(files["j"][k], files["t"][k])
    src = str(tmp_path / "lab.nii.gz")
    save_nifti(src, lab, aff)
    mj, _ = JS1.create_target_mask(src, [4.0, -6.0, 2.0],
                                   str(tmp_path / "j_mask.nii.gz"), (2, 1, 3))
    mt, pt = TS1.create_target_mask(src, [4.0, -6.0, 2.0],
                                    str(tmp_path / "t_mask.nii.gz"), (2, 1, 3))
    _equal(mt, mj)
    assert pt.endswith("t_mask.nii.gz") and mt.sum() > 5
    with pytest.raises(ValueError, match="out of bounds"):
        TS1.create_target_mask(src, [400.0, 0.0, 0.0])


# ---------------------------------------------------------------------------
# gifti and plantus
# ---------------------------------------------------------------------------


def _same_gii(pj, pt, read):
    """Both files read alike by both packages' readers (the bytes carry the
    gzip time stamp)."""
    out = [getattr(mod, read)(str(p)) for mod in (JG, TG) for p in (pj, pt)]
    for o in out[1:]:
        _equal(o, out[0])


def test_gifti_matches_jax(tmp_path):
    """The round trips of `tests/test_plantus.py:172-203`, written by both
    packages to the same bytes and read back alike."""
    rng = np.random.default_rng(0)
    verts = rng.normal(size=(50, 3)).astype(np.float32) * 40
    faces = rng.integers(0, 50, (80, 3)).astype(np.int32)
    xf = np.eye(4)
    xf[:3, 3] = (5.0, -3.0, 2.0)
    vals = rng.normal(size=50).astype(np.float32)
    vals2 = rng.normal(size=(50, 3)).astype(np.float32)
    for name, mod in (("j", JG), ("t", TG)):
        mod.write_surf_gii(str(tmp_path / f"{name}.surf.gii"), verts, faces)
        mod.write_surf_gii(str(tmp_path / f"{name}x.surf.gii"), verts, faces,
                           transform=xf)
        mod.write_func_gii(str(tmp_path / f"{name}.func.gii"), vals,
                           name="score")
        mod.write_func_gii(str(tmp_path / f"{name}2.func.gii"), vals2)
    for f in ("%s.surf.gii", "%sx.surf.gii", "%s.func.gii", "%s2.func.gii"):
        read = "read_surf_gii" if "surf" in f else "read_func_gii"
        _same_gii(tmp_path / (f % "j"), tmp_path / (f % "t"), read)
    _equal(TG.vertex_normals(verts, faces), JG.vertex_normals(verts, faces))


@pytest.fixture(scope="module")
def sphere_head():
    """`tests/test_plantus.py`'s concentric spheres, 1 mm grid."""
    from babelbrain_tpu_torch.pipeline.step1 import LABELS

    n = 96
    lab = np.zeros((n, n, n), np.uint8)
    c = np.array([n / 2, n / 2, n / 2])
    ii = np.indices(lab.shape).astype(np.float64)
    r = np.sqrt(((ii - c[:, None, None, None]) ** 2).sum(0))
    lab[r < 40] = LABELS["skin"]
    lab[r < 37] = LABELS["cortical"]
    lab[r < 32] = LABELS["brain"]
    return lab, np.eye(4), c


def _placements(mod, lab, affine, target, **kw):
    cfg = mod.PlanTUSConfig(max_distance=80.0, min_distance=5.0,
                            optimal_distance=25.0, transducer_diameter=64.0,
                            max_angle=20.0)
    return mod.suggest_placements(lab, affine, target, cfg, top_k=5, **kw)


def test_plantus_placements_match_jax(sphere_head, tmp_path):
    lab, affine, c = sphere_head
    target = c + np.array([0.0, 0.0, 18.0])
    rj = _placements(JPL, lab, affine, target)
    rt = _placements(TPL, lab, affine, target)
    _equal(dataclasses.asdict(rt), dataclasses.asdict(rj))
    _equal(rt.trajectory(0), rj.trajectory(0))
    _equal(TPL.metric_volume(lab, affine, rt, "score"),
           JPL.metric_volume(lab, affine, rj, "score"))
    JPL.export_placements_csv(str(tmp_path / "j.csv"), rj)
    TPL.export_placements_csv(str(tmp_path / "t.csv"), rt)
    _same_file(tmp_path / "j.csv", tmp_path / "t.csv")
    # the scalp mesh as the candidate set, and its per-vertex metric map
    vj = JPL.export_scalp_surf_gii(str(tmp_path / "j.surf.gii"), lab, affine)
    vt = TPL.export_scalp_surf_gii(str(tmp_path / "t.surf.gii"), lab, affine)
    _equal(vt, vj)
    _same_gii(tmp_path / "j.surf.gii", tmp_path / "t.surf.gii",
              "read_surf_gii")
    mj = _placements(JPL, lab, affine, target, scalp_mesh=vj)
    mt = _placements(TPL, lab, affine, target, scalp_mesh=vt)
    _equal(dataclasses.asdict(mt), dataclasses.asdict(mj))
    _equal(TPL.export_metric_func_gii(str(tmp_path / "t.func.gii"), mt,
                                      len(vt[0])),
           JPL.export_metric_func_gii(str(tmp_path / "j.func.gii"), mj,
                                      len(vj[0])))
    _same_gii(tmp_path / "j.func.gii", tmp_path / "t.func.gii",
              "read_func_gii")


def test_plantus_analytic_helpers_match_jax(tmp_path):
    _equal(TPL.find_tpo_equivalent(500e3, 64e-3, 63.2e-3),
           JPL.find_tpo_equivalent(500e3, 64e-3, 63.2e-3))
    _equal(TPL.acoustic_axis_oneil(500e3, 64e-3, 63.2e-3, c=1500.0),
           JPL.acoustic_axis_oneil(500e3, 64e-3, 63.2e-3, c=1500.0))
    kw = dict(max_distance=80.0, min_distance=30.0, optimal_distance=55.0,
              transducer_diameter=65.0, max_angle=15.0, plane_offset=9.5,
              additional_offset=2.0, focal_distance_list=[40.0, 60.0, 80.0],
              flhm_list=[18.0, 25.0, 33.0])
    cj, ct = JPL.PlanTUSConfig(**kw), TPL.PlanTUSConfig(**kw)
    for depth in (50.0, 100.0):
        assert TPL.recommended_focal_setting(ct, depth) == \
            JPL.recommended_focal_setting(cj, depth)
    kw2 = {k: kw[k] for k in list(kw)[:5]}
    assert TPL.recommended_focal_setting(TPL.PlanTUSConfig(**kw2), 55.0) == \
        JPL.recommended_focal_setting(JPL.PlanTUSConfig(**kw2), 55.0)
    cj.export_yaml(str(tmp_path / "j.yaml"))
    ct.export_yaml(str(tmp_path / "t.yaml"))
    _same_file(tmp_path / "j.yaml", tmp_path / "t.yaml")
