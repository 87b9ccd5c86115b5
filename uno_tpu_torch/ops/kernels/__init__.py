"""The port's hand-written CUDA kernels and their wrappers.

Importing the package registers the forward launches as ``torch.library``
custom ops, ``uno_tpu_torch::contract`` (``cmul.py``),
``uno_tpu_torch::mlp_head_fwd`` (``mlp_head.py``) and
``uno_tpu_torch::remap`` (``remap.py``): a program exported by
``uno_tpu_torch.export`` holds them as nodes and needs them to load.  It
builds nothing (``_build.py`` compiles at the first launch).
"""

from uno_tpu_torch.ops.kernels import cmul, mlp_head, remap  # noqa: F401
