"""The port's own copies of the JAX package's host modules give the same
results: materials (tissue table, HU mappings, thermal list, SDR),
transducer geometry and element tables, and the BLOSC codec."""

import numpy as np
import pytest

from babelbrain_tpu import materials as JM
from babelbrain_tpu import native as JN
from babelbrain_tpu import tx as JT
from babelbrain_tpu.materials import pseudo_ct as JP
from babelbrain_tpu_torch import materials as TM
from babelbrain_tpu_torch import native as TN
from babelbrain_tpu_torch import tx as TT
from babelbrain_tpu_torch.materials import pseudo_ct as TP


@pytest.mark.parametrize("method", sorted(JM.MAPPING_METHODS))
def test_hu_mappings_equal(method):
    hu = np.linspace(100.0, 2400.0, 301)
    for a, b in zip(JM.map_hu_to_properties(hu, 500e3, method),
                    TM.map_hu_to_properties(hu, 500e3, method)):
        np.testing.assert_array_equal(a, b)


def test_tissue_and_thermal_tables_equal():
    tissues = ["Water", "Skin", "Cortical", "Trabecular", "Brain"]
    for f0 in (250e3, 500e3, 700e3):
        np.testing.assert_array_equal(JM.material_array(f0, tissues),
                                      TM.material_array(f0, tissues))
        assert JM.smallest_sos(f0, include_shear=True) == TM.smallest_sos(
            f0, include_shear=True)
    acoustic = JM.material_array(500e3, tissues)
    a = JM.build_thermal_material_list(acoustic, ct_mode=False,
                                       segmented_brain=False)
    b = TM.build_thermal_material_list(acoustic, ct_mode=False,
                                       segmented_brain=False)
    for k in vars(a):
        np.testing.assert_array_equal(np.asarray(getattr(a, k)),
                                      np.asarray(getattr(b, k)), err_msg=k)


def test_sdr_equal():
    rng = np.random.default_rng(2)
    hu = rng.uniform(200.0, 1800.0, (20, 20, 24))
    skull = np.zeros(hu.shape, bool)
    skull[:, :, 8:16] = True
    assert JP.compute_sdr(hu, skull, spacing_mm=1.0) == TP.compute_sdr(
        hu, skull, spacing_mm=1.0)


def test_transducer_geometry_and_tables_equal():
    a = JT.make_focused_bowl(500e3, 63.2e-3, 64e-3, 1500.0)
    b = TT.make_focused_bowl(500e3, 63.2e-3, 64e-3, 1500.0)
    for k in ("centers", "areas", "normals", "elem_ids", "elem_centers"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    for dev in JT.TABLE_DEVICES:
        np.testing.assert_array_equal(JT.element_table(dev),
                                      TT.element_table(dev), err_msg=dev)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_blosc_codec_equal_and_roundtrips(dtype):
    rng = np.random.default_rng(4)
    arr = (rng.integers(0, 6, 70000) if dtype == np.uint8
           else rng.normal(0, 1, 70000)).astype(dtype)
    raw = arr.tobytes()
    chunk = TN.blosc_compress(raw, typesize=arr.itemsize)
    assert chunk == JN.blosc_compress(raw, typesize=arr.itemsize)
    assert TN.blosc_decompress(chunk) == raw
