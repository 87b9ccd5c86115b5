"""uno_tpu_torch: the PyTorch/CUDA port of uno_tpu for NVIDIA Hopper.

It grows beside the JAX package ``uno_tpu``, which stays the reference the
port is tested against.  It imports ``torch`` and never ``jax``.  Its hand
written CUDA kernels live in ``csrc/`` and are built at first use
(``ops/kernels/_build.py``).

Layout:
    ops/       numerics: spectral convs (FFT and partial-DFT paths), resampling,
               norms; ops/kernels: the CUDA kernels' wrappers
    nn/        layers (SpectralConv, PointwiseOp, OperatorBlock, Dense)
    models/    the U-NO families (Darcy 2D, NS 2D, NS 3D spatiotemporal)
    optim      complex-aware Adam and the StepLR schedule
    losses     relative Lp loss
    data/      .mat readers, loaders, the Darcy and NS generators
    train/     the Darcy, NS-2D and NS-3D trainers, checkpoints, metrics
    parallel/  the (data x spatial) mesh of ranks: data parallelism, spatial
               domain decomposition, channel tensor parallelism
"""

__version__ = "0.1.0"

# lazy top-level names, as uno_tpu has them (uno_tpu's ``complex_adam`` is
# the class ``ComplexAdam`` here)
_LAZY = {
    "uno_tpu_torch.models": ("build_model", "MODEL_REGISTRY", "UNOModel", "UNOSpec"),
    "uno_tpu_torch.train": ("TrainConfig", "train_darcy", "train_ns2d", "train_ns3d"),
    "uno_tpu_torch.export": ("export_forward", "load_forward"),
    "uno_tpu_torch.losses": ("relative_lp_loss",),
    "uno_tpu_torch.optim": ("ComplexAdam", "step_lr"),
}


def __getattr__(name):
    import importlib

    for module, names in _LAZY.items():
        if name in names:
            return getattr(importlib.import_module(module), name)
    raise AttributeError(name)
