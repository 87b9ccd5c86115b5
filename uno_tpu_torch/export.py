"""The serving artifact (port of ``uno_tpu/export.py``).

``export_forward`` traces the model's forward with ``torch.export`` at one
input shape (one artifact per serving shape, as in ``uno_tpu``) and saves
the ``ExportedProgram``: the graph of aten ops, with the trained weights
baked in, as one self-contained file.  The port's hand-written kernels are
``torch.library`` custom ops (``uno_tpu_torch::contract``,
``uno_tpu_torch::mlp_head_fwd``, ``uno_tpu_torch::remap``), so the graph
holds each launch as a node, and running it launches the CUDA kernel on the
card (the plain version on the CPU).

``load_forward`` needs those ops registered, so it imports
``uno_tpu_torch.ops.kernels``, and nothing of the model-building code
(``uno_tpu_torch.models``, ``nn``, ``ops.spectral``): this is the port's
counterpart of ``uno_tpu``'s "loads without model-building code".  Its
``device`` stands in for ``uno_tpu``'s ``platforms``: export on a CPU build
host, then move the program to the card where it serves
(``torch.export.passes.move_to_device_pass``).
"""

from __future__ import annotations

import io
from typing import Optional, Union

import torch


def export_forward(model: torch.nn.Module, sample: torch.Tensor,
                   path: Optional[str] = None) -> bytes:
    """Export ``model``'s eval-mode forward at ``sample``'s shape, dtype and
    device; returns the saved program's bytes, also written to ``path``."""
    with torch.no_grad():
        program = torch.export.export(model.eval(), (sample,), strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    data = buf.getvalue()
    if path:
        with open(path, "wb") as f:
            f.write(data)
    return data


def load_forward(path_or_bytes: Union[str, bytes, bytearray],
                 device: Optional[Union[str, torch.device]] = None) -> torch.nn.Module:
    """Load an artifact; returns a module ``fn(x) -> y``, moved to
    ``device`` first when given."""
    import uno_tpu_torch.ops.kernels  # noqa: F401  (registers the custom ops)

    src = (io.BytesIO(bytes(path_or_bytes))
           if isinstance(path_or_bytes, (bytes, bytearray)) else path_or_bytes)
    program = torch.export.load(src)
    if device is not None:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, torch.device(device))
    return program.module()
