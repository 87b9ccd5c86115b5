"""The plug-ins a configuration names, found by name: its model family
(``"reference"``: ``benchmark/reference/<name>.py``) and its task
(``"task"``: ``benchmark/tasks/<name>.py``).  A configuration of another
family, dimension or task joins the benchmark with new files of these kinds
and edits none.

A family module declares the configuration keys it reads (``CONFIG_KEYS``:
top-level keys beyond the harness's own, ``common.CONFIG_KEYS``;
``MODEL_KEYS``: the ``model`` section's, all present; ``BLOCK_KEYS``: what a
block may hold) and gives the plain reference (``forward``, ``rel_l2_sum``,
``Adam``, ``step_lr``, ``bf16_round``, ``fp8_round``, and ``rollout`` where a
task feeds predictions back), the weights (``leaves``), the check that the
program builds the architecture the file states (``check_spec``) and the
counts of its work (``step_flops``, ``bounds``).

A task module makes the data from the seed (``train_split``,
``serve_inputs``) and says how the program and the reference meet it: the
program's loss (``program_loss``) and serving call (``program_serve``), the
reference's loss (``reference_loss``) and answer (``reference_answer``).
A task whose trainer adds something other than its loss to the epoch's sum
gives ``logged``: its ``program_loss`` then returns ``(loss, aux)``, and
each step adds ``logged(aux, y)``, taken without gradients after the
optimizer's step.  A driver needs only what its cells use.
"""

from __future__ import annotations

import importlib
import re

NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def _module(package: str, name: str):
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"{package} {name!r}: a plug-in's name is a Python identifier")
    return importlib.import_module(f"benchmark.{package}.{name}")


def family(cfg: dict):
    """The configuration's model family: ``benchmark/reference/<reference>.py``."""
    return _module("reference", cfg["reference"])


def task(cfg: dict):
    """The configuration's task: ``benchmark/tasks/<task>.py``."""
    return _module("tasks", cfg["task"])
