from .database import (  # noqa: F401
    DB_TO_NEPER,
    TISSUES,
    material_array,
    smallest_sos,
    speed_of_sound_water,
    tissue_properties,
)
from .ct_mapping import MAPPING_METHODS, map_hu_to_properties, quantize_hu  # noqa: F401
from .thermal import ThermalMaterialList, build_thermal_material_list  # noqa: F401
