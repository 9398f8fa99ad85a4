"""Cognition layer: world-model construction, batch-first (the JAX
package's ``cognition/``).

The reference's NearestLocator / DrivingSpaceConstructor build a
``MapState`` from the static map, the tracked objects and the ego pose at
20 Hz per vehicle; here the same construction is one function of [..., K]
tracked objects x [..., L] lanes for every env of a batch.
"""

from dcarl_tpu_torch.cognition.drivable import dynamic_boundary
from dcarl_tpu_torch.cognition.locator import (EgoPose, LightSignal,
                                               MapModel, StaticLocalMap,
                                               StopState, TrackedObjects,
                                               TrafficLightDetection,
                                               locate_objects_in_lane,
                                               locate_traffic_lights_in_lanes,
                                               update_map_state)
from dcarl_tpu_torch.cognition.path_buffer import (PathBufferState,
                                                   path_buffer_init,
                                                   path_buffer_update)

__all__ = [
    "StaticLocalMap", "TrackedObjects", "EgoPose", "MapModel",
    "LightSignal", "StopState", "TrafficLightDetection",
    "locate_objects_in_lane", "locate_traffic_lights_in_lanes",
    "update_map_state", "PathBufferState", "path_buffer_init",
    "path_buffer_update", "dynamic_boundary",
]
