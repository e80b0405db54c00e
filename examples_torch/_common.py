"""Shared plumbing of the port's examples: the repository on the path, and
the device they run on.

The examples run on the card unless the caller asks for the CPU, with
``--cpu`` on the command line or ``EXAMPLES_CPU=1`` in the environment (the
tests do the latter); a rank started by ``python -m parsec_tpu_torch.launch
--cpu`` carries ``PARSEC_TPU_TORCH_FORCE_CPU=1``."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device() -> str:
    """``"cpu"`` when the caller asked for it, else ``"cuda"``."""
    if "--cpu" in sys.argv[1:] or os.environ.get("EXAMPLES_CPU") == "1" \
            or os.environ.get("PARSEC_TPU_TORCH_FORCE_CPU") == "1":
        return "cpu"
    return "cuda"
