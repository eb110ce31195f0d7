"""trino_tpu_torch — the PyTorch/CUDA port of trino_tpu.

The SQL frontend and the planner are copies of the reference package's
framework-neutral modules; pages are torch tensors on the device the runner
was given, and the kernels the reference wrote in Pallas for the TPU are
hand-written CUDA for Hopper (``ops/hopper_kernels.py``, ``csrc/``).

Importing the package sets no global state: every tensor the port creates
names its dtype and its device.
"""

__version__ = "0.1.0"

from .device import resolve_device  # noqa: E402,F401
