"""Vehicle driver protocol layer (host-side).

Typed equivalents of the reference's vendor message packs
(software/src/driver/messages/*: xpmotors CAN, novatel GNSS,
continental/srr/us radar) plus the binary codecs the ROS drivers left
to vendor hardware: CAN frame bit-packing, GPCHC sentence parsing, and
radar-array ingestion into the cognition layer's array format.

Nothing here touches the GPU — this is the host edge of the stack; the
arrays it produces feed ``dcarl_tpu_torch.cognition`` /
``dcarl_tpu_torch.ops``.  A copy of ``dcarl_tpu/driver`` (same names,
same outputs), kept in the port so that it imports nothing of the JAX
package.
"""

from dcarl_tpu_torch.driver.messages import (AutoCtlReq, AutoState,
                                             AutoStateEx, EPSStatus,
                                             ESCStatus, GpChc, Header,
                                             InsPva, RadarObs)
from dcarl_tpu_torch.driver.can_codec import (CAN_IDS, decode_frame,
                                              encode_frame)
from dcarl_tpu_torch.driver.gnss import (geodetic_to_enu, gpchc_sentence,
                                         parse_gpchc, pose_from_inspva)
from dcarl_tpu_torch.driver.radar import radar_to_tracked_arrays

__all__ = [
    "AutoCtlReq", "AutoState", "AutoStateEx", "EPSStatus", "ESCStatus",
    "GpChc", "Header", "InsPva", "RadarObs", "CAN_IDS", "decode_frame",
    "encode_frame", "geodetic_to_enu", "gpchc_sentence", "parse_gpchc",
    "pose_from_inspva", "radar_to_tracked_arrays",
]
