"""Shim: reference path ``edge/parameter_tuning/call_c_fun.py``."""

from audio_processing_tools_tpu_torch.tuning.call_native import (  # noqa: F401
    FREQ_BAND,
    evmgr_sensor_data_t,
    evmgr_data_input_t,
    rain_cl_optional_data_t,
    rain_cl_config_param_t,
    load_native_library,
    rain_detection_algo,
    get_version,
)
from audio_processing_tools_tpu_torch.tuning.device_backend import (  # noqa: F401
    rain_detection_algo_device,
)
