"""PyTorch/CUDA port of DCARL-TPU.

A second package beside ``dcarl_tpu`` (the JAX reference, which it never
imports).  Module paths mirror the JAX package so each counterpart is
found under the same name; public functions keep its lane-major
(batch-last) layouts.  The store query that the gated deployment driver
runs every tick is a CUDA kernel written for Hopper
(``csrc/peraction_moments.cu``), built at first use.
"""

from dcarl_tpu_torch import config as config
from dcarl_tpu_torch.device import disable_tf32, resolve_device

__all__ = ["config", "disable_tf32", "resolve_device"]
