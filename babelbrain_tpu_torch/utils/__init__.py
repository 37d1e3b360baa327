from .timing import clear_spans, recorded_spans, stage_timer  # noqa: F401
