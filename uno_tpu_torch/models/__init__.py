import dataclasses

from uno_tpu_torch.models.core import LIFT, BlockSpec, UNOModel, UNOSpec
from uno_tpu_torch.models.uno2d import uno, uno9, uno11, uno_demo, uno_p, uno_s256
from uno_tpu_torch.models.uno3d import (
    uno3d_t9,
    uno3d_t9_256,
    uno3d_t10,
    uno3d_t10_256,
    uno3d_t20,
    uno3d_t20_256,
    uno3d_t40,
    uno3d_t40_256,
)

# uno_tpu's registry: the 2-D and the 3-D families
MODEL_REGISTRY = {
    "uno9": uno9,
    "uno11": uno11,
    "uno": uno,
    "uno_p": uno_p,
    "uno_s256": uno_s256,
    "uno_demo": uno_demo,
    "uno3d_t40": uno3d_t40,
    "uno3d_t20": uno3d_t20,
    "uno3d_t10": uno3d_t10,
    "uno3d_t9": uno3d_t9,
    "uno3d_t40_256": uno3d_t40_256,
    "uno3d_t20_256": uno3d_t20_256,
    "uno3d_t10_256": uno3d_t10_256,
    "uno3d_t9_256": uno3d_t9_256,
}


def build_model(name: str, dtype=None, remat_blocks=None, pad_to=None, device=None,
                generator=None, **kwargs) -> UNOModel:
    """A UNOModel for a registered spec name.

    ``dtype`` ('float32' | 'bfloat16'), ``remat_blocks`` and ``pad_to``
    override the spec's precision, rematerialisation and padding policies;
    parameters are drawn from ``generator`` and placed on ``device``.
    """
    spec = MODEL_REGISTRY[name](**kwargs)
    over = {k: v for k, v in (("dtype", dtype), ("remat_blocks", remat_blocks),
                              ("pad_to", pad_to)) if v is not None}
    if over:
        spec = dataclasses.replace(spec, **over)
    return UNOModel(spec, device=device, generator=generator)


__all__ = [
    "LIFT",
    "BlockSpec",
    "UNOModel",
    "UNOSpec",
    "MODEL_REGISTRY",
    "build_model",
    "uno",
    "uno9",
    "uno11",
    "uno_p",
    "uno_s256",
    "uno_demo",
    "uno3d_t40",
    "uno3d_t20",
    "uno3d_t10",
    "uno3d_t9",
    "uno3d_t40_256",
    "uno3d_t20_256",
    "uno3d_t10_256",
    "uno3d_t9_256",
]
