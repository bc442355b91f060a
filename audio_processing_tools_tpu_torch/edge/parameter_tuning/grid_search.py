"""Shim: reference path ``edge/parameter_tuning/grid_search.py``."""

from audio_processing_tools_tpu_torch.tuning.grid_search import (  # noqa: F401
    grid_search,
    grid_search_parallel,
    grid_search_vmapped,
    generate_param_combinations,
    load_processed_param_ids,
    save_result_to_disk,
    params_to_filename,
    replace_callables,
)
