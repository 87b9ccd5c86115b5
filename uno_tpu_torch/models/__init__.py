import dataclasses

from uno_tpu_torch.models.core import LIFT, BlockSpec, UNOModel, UNOSpec
from uno_tpu_torch.models.uno2d import uno, uno9, uno11, uno_demo, uno_p, uno_s256

# the 2-D registry of uno_tpu; the 3-D models are not ported yet
MODEL_REGISTRY = {
    "uno9": uno9,
    "uno11": uno11,
    "uno": uno,
    "uno_p": uno_p,
    "uno_s256": uno_s256,
    "uno_demo": uno_demo,
}


def build_model(name: str, dtype=None, pad_to=None, device=None,
                generator=None, **kwargs) -> UNOModel:
    """A UNOModel for a registered spec name.

    ``dtype`` ('float32' | 'bfloat16') and ``pad_to`` override the spec's
    precision and padding policies; parameters are drawn from ``generator``
    and placed on ``device``.
    """
    spec = MODEL_REGISTRY[name](**kwargs)
    over = {k: v for k, v in (("dtype", dtype), ("pad_to", pad_to)) if v is not None}
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
]
