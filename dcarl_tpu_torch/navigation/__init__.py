"""Navigation layer: static map provision and routing (the JAX package's
``navigation/``).

Recorded loop polylines, or an OpenDrive network, are windowed around
each ego into fixed-shape local maps that the cognition layer reads.
"""

from dcarl_tpu_torch.navigation import route as route
from dcarl_tpu_torch.navigation.map_provider import (LoopMap, load_loop_map,
                                                     synthetic_loop_map,
                                                     window_static_map)

__all__ = ["LoopMap", "load_loop_map", "synthetic_loop_map",
           "window_static_map", "route"]
