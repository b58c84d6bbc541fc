"""mptrac_tpu_torch: the PyTorch/CUDA port of mptrac_tpu.

A second package beside the JAX package ``mptrac_tpu``, which stays the
reference: same sub-package layout and function names, plain functions
on torch tensors inside, and the TPU kernels rewritten by hand as CUDA
kernels for NVIDIA Hopper (``csrc/``, built at first use).  This package
imports ``torch`` and numpy, never ``jax`` and nothing of ``mptrac_tpu``.

Every constructor and entry point takes an explicit ``device`` that
defaults to ``"cuda"`` and raises if no GPU is present; pass ``"cpu"``
to run the plain PyTorch versions of the kernels (as the tests do).

Every module of the JAX package has its counterpart here: the timestep
with all of its physics, the met and particle formats, the output
writers, the parallel layer, the command-line tools (``tools``) and the
web runner (``web.runner``).
"""

from mptrac_tpu_torch import constants  # noqa: F401
from mptrac_tpu_torch.config import Ctl, read_ctl  # noqa: F401
from mptrac_tpu_torch.types import (Atm, Cache, Clim, Met,  # noqa: F401
                                    astype_state, stack_met)
from mptrac_tpu_torch.timeutil import jsec2time, time2jsec  # noqa: F401

__version__ = "0.1.0"

__all__ = ["Atm", "Cache", "Clim", "Ctl", "Met", "astype_state",
           "constants", "jsec2time", "read_ctl", "stack_met", "time2jsec"]
