"""Host utilities of the port: metrics logging, checkpoints and the
store's text history, the NaN guard, module monitoring, field-log
analysis and visualization (``dcarl_tpu/utils``).  ``profiling`` and
``native`` (the ctypes binding of the C++ host library, built at first
use) are imported by name."""

from dcarl_tpu_torch.utils import logging as logging
from dcarl_tpu_torch.utils import checkpoint as checkpoint
from dcarl_tpu_torch.utils import nan_guard as nan_guard
from dcarl_tpu_torch.utils import monitor as monitor
from dcarl_tpu_torch.utils import field_analysis as field_analysis
from dcarl_tpu_torch.utils import visualize as visualize
