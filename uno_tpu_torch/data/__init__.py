from uno_tpu_torch.data.batching import epoch_batches, num_batches
from uno_tpu_torch.data.darcy_solver import generate_darcy_batch, solve_darcy
from uno_tpu_torch.data.grf import GaussianRF, darcy_grf
from uno_tpu_torch.data.loaders import load_darcy, load_darcy_multi, load_navier_stokes
from uno_tpu_torch.data.mat import MatReader
from uno_tpu_torch.data.ns_solver import default_forcing, navier_stokes_2d

__all__ = [
    "epoch_batches",
    "num_batches",
    "generate_darcy_batch",
    "solve_darcy",
    "GaussianRF",
    "darcy_grf",
    "load_darcy",
    "load_darcy_multi",
    "load_navier_stokes",
    "MatReader",
    "default_forcing",
    "navier_stokes_2d",
]
