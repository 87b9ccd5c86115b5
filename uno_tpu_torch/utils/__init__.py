from uno_tpu_torch.utils.profiling import annotate, enable_nan_debugging, trace

__all__ = ["annotate", "enable_nan_debugging", "trace"]
