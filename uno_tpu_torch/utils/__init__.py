from uno_tpu_torch.utils.profiling import (
    annotate,
    enable_nan_debugging,
    start_recording,
    stop_recording,
    trace,
)

__all__ = ["annotate", "enable_nan_debugging", "start_recording", "stop_recording", "trace"]
