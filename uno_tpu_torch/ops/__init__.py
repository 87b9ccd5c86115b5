"""The numerics (port of ``uno_tpu/ops``).  The names below are loaded on
first use, so that importing ``uno_tpu_torch.ops.kernels`` alone (as
``export.load_forward`` does to serve an artifact) loads none of the
model-building code."""

_NAMES = {
    "uno_tpu_torch.ops.norm": ("instance_norm",),
    "uno_tpu_torch.ops.resample": ("resize", "resize_matrix"),
    "uno_tpu_torch.ops.spectral": (
        "default_modes_1d",
        "default_modes_2d",
        "default_modes_3d",
        "fourier_truncate_3d",
        "spectral_conv_1d",
        "spectral_conv_2d",
        "spectral_conv_3d",
        "spectral_weight_init",
    ),
}
__all__ = [name for names in _NAMES.values() for name in names]


def __getattr__(name):
    import importlib

    for module, names in _NAMES.items():
        if name in names:
            return getattr(importlib.import_module(module), name)
    raise AttributeError(name)
