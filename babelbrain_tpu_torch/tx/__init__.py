from .geometry import (  # noqa: F401
    Transducer,
    cap_area,
    make_annular_array,
    make_concave_array,
    make_flat_array_from_positions,
    make_flat_grid_array,
    make_flat_ring_array,
    make_focused_bowl,
    make_spherical_cap,
)
from .tables import (  # noqa: F401
    TABLE_DEVICES,
    dome_element_areas_mm2,
    element_table,
    remopd_positions,
)
