"""CAN frame codec for the xpmotors control/state messages.

The reference's xpmotors driver node converts vendor CAN frames to the
ROS messages of ``xpmotors_can_msgs`` inside a closed-source vendor lib
(only the .msg schemas ship in the repo).  This codec defines an
explicit, documented 8-byte layout per message — scale/offset quantized
little-endian fields — so field logs and HIL rigs can round-trip the
same typed messages without ROS or the vendor stack.

Layouts (8-byte payload, little-endian):

  AutoCtlReq  (0x110): u8 AutoMode | u8 VoiceAlarm | u16 TarSpeedReq
               (0.01 km/h) | i16 EPSAngleReq (0.1 deg) | u8 TurnLight
  AutoState   (0x201): u8 EPBState | u8 GearState | u8 BrkPedal |
               u8 AccPedal
  AutoStateEx (0x202): u8 StateTurningLight | u8 CurDriveMode |
               u8 StateBraking
  EPSStatus   (0x203): i16 AngleSpd (0.1 deg/s) | i16 Angle (0.1 deg) |
               i16 StrngWhlTorq (0.01 Nm)
  ESCStatus   (0x204): 4 x u16 wheel speed (0.01 km/h)
"""

from __future__ import annotations

import struct
from typing import Tuple, Union

from dcarl_tpu_torch.driver.messages import (AutoCtlReq, AutoState,
                                             AutoStateEx, EPSStatus,
                                             ESCStatus)

CAN_IDS = {
    AutoCtlReq: 0x110,
    AutoState: 0x201,
    AutoStateEx: 0x202,
    EPSStatus: 0x203,
    ESCStatus: 0x204,
}
_BY_ID = {v: k for k, v in CAN_IDS.items()}

Msg = Union[AutoCtlReq, AutoState, AutoStateEx, EPSStatus, ESCStatus]


def _q(value: float, scale: float, lo: int, hi: int) -> int:
    return max(lo, min(hi, int(round(value / scale))))


def encode_frame(msg: Msg) -> Tuple[int, bytes]:
    """-> (can_id, 8-byte payload)."""
    if isinstance(msg, AutoCtlReq):
        payload = struct.pack(
            "<BBHhB x",
            msg.AutoMode & 0xFF, msg.VoiceAlarm & 0xFF,
            _q(msg.TarSpeedReq, 0.01, 0, 0xFFFF),
            _q(msg.EPSAngleReq, 0.1, -0x8000, 0x7FFF),
            msg.TurnLight & 0xFF)
    elif isinstance(msg, AutoState):
        payload = struct.pack("<BBBB4x", msg.EPBState & 0xFF,
                              msg.GearState & 0xFF, msg.BrkPedal & 0xFF,
                              msg.AccPedal & 0xFF)
    elif isinstance(msg, AutoStateEx):
        payload = struct.pack("<BBB5x", msg.StateTurningLight & 0xFF,
                              msg.CurDriveMode & 0xFF,
                              msg.StateBraking & 0xFF)
    elif isinstance(msg, EPSStatus):
        payload = struct.pack(
            "<hhh2x",
            _q(msg.AngleSpd, 0.1, -0x8000, 0x7FFF),
            _q(msg.Angle, 0.1, -0x8000, 0x7FFF),
            _q(msg.StrngWhlTorq, 0.01, -0x8000, 0x7FFF))
    elif isinstance(msg, ESCStatus):
        payload = struct.pack(
            "<HHHH",
            _q(msg.RRWheelSpd, 0.01, 0, 0xFFFF),
            _q(msg.LFWheelSpd, 0.01, 0, 0xFFFF),
            _q(msg.RFWheelSpd, 0.01, 0, 0xFFFF),
            _q(msg.LRWheelSpd, 0.01, 0, 0xFFFF))
    else:
        raise TypeError(f"no CAN layout for {type(msg).__name__}")
    assert len(payload) == 8
    return CAN_IDS[type(msg)], payload


def decode_frame(can_id: int, payload: bytes, stamp: float = 0.0) -> Msg:
    """Inverse of :func:`encode_frame` (values dequantized)."""
    if len(payload) != 8:
        raise ValueError("CAN payload must be 8 bytes")
    cls = _BY_ID.get(can_id)
    if cls is None:
        raise KeyError(f"unknown CAN id 0x{can_id:x}")
    if cls is AutoCtlReq:
        a, v, spd, ang, tl = struct.unpack("<BBHhB x", payload)
        m = AutoCtlReq(AutoMode=a, VoiceAlarm=v, TarSpeedReq=spd * 0.01,
                       EPSAngleReq=ang * 0.1, TurnLight=tl)
    elif cls is AutoState:
        e, g, b, acc = struct.unpack("<BBBB4x", payload)
        m = AutoState(EPBState=e, GearState=g, BrkPedal=b, AccPedal=acc)
    elif cls is AutoStateEx:
        t, d, b = struct.unpack("<BBB5x", payload)
        m = AutoStateEx(StateTurningLight=t, CurDriveMode=d, StateBraking=b)
    elif cls is EPSStatus:
        spd, ang, tq = struct.unpack("<hhh2x", payload)
        m = EPSStatus(AngleSpd=spd * 0.1, Angle=ang * 0.1,
                      StrngWhlTorq=tq * 0.01)
    else:
        rr, lf, rf, lr = struct.unpack("<HHHH", payload)
        m = ESCStatus(RRWheelSpd=rr * 0.01, LFWheelSpd=lf * 0.01,
                      RFWheelSpd=rf * 0.01, LRWheelSpd=lr * 0.01)
    m.header.stamp = stamp
    return m
