"""Headless Step 1 -> Step 2 -> Step 3 pipeline (CT mode and label mode).

Exports the names of ``babelbrain_tpu/pipeline/__init__.py``. As there, the
benchmark-file media and the layer transmission (``benchmark``), the
transducer calibration (``calibration``) and the out-of-process steps
(``workers``) are imported from their modules.
"""

from .domain import (  # noqa: F401
    Domain,
    build_ct_materials,
    build_domain,
    build_label_materials,
    compute_time_stepping,
    cone_padding_cells,
    remap_labels,
    snap_ppp,
)
from .runner import CaseConfig, run_case, run_cases  # noqa: F401
from .acoustic import (  # noqa: F401
    AcousticResult,
    forward_rayleigh,
    position_transducer,
    run_acoustic_sim,
    run_dome_sim,
    run_multipoint,
)
from .plantus import (  # noqa: F401
    PlacementResult,
    PlanTUSConfig,
    recommended_focal_setting,
    suggest_placements,
)
from .thermal import (  # noqa: F401
    SonicationParams,
    ThermalResult,
    analyze_losses,
    run_sonication,
    thermal_out_name,
    tissue_region_masks,
)
from .io import Nifti, load_dict_h5, load_nifti, save_dict_h5, save_nifti  # noqa: F401
from .step1 import Step1Result, generate_mask  # noqa: F401
from .profiles import (  # noqa: F401
    TRANSDUCER_REGISTRY,
    TransducerSpec,
    build_transducer,
    load_thermal_profile,
)
