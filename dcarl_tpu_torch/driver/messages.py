"""Typed vendor messages (driver/messages/*/msg/*.msg re-typed).

Field names and units mirror the reference .msg schemas exactly so
field-log tooling ports 1:1:

* xpmotors CAN: AutoCtlReq / AutoState / AutoStateEx / EPSStatus /
  ESCStatus (xpmotors_can_msgs/msg/*.msg)
* continental radar: RadarObs (continental_radar_msgs/msg/RadarObs.msg)
* novatel GNSS: InsPva (novatel_gnss_msgs/msg/InsPva.msg), GpChc
  (novatel_gnss_msgs/msg/GpChc.msg)

ROS Headers collapse to a float stamp + frame string.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Header:
    stamp: float = 0.0
    frame_id: str = ""


@dataclasses.dataclass
class AutoCtlReq:
    """Autonomy control request (xpmotors_can_msgs/msg/AutoCtlReq.msg)."""

    header: Header = dataclasses.field(default_factory=Header)
    AutoMode: int = 0          # uint8
    VoiceAlarm: int = 0        # uint8
    TarSpeedReq: float = 0.0   # float32, km/h
    EPSAngleReq: float = 0.0   # float32, steering-wheel degrees
    TurnLight: int = 0         # uint8


@dataclasses.dataclass
class AutoState:
    """Pedal/gear state (AutoState.msg)."""

    header: Header = dataclasses.field(default_factory=Header)
    EPBState: int = 0
    GearState: int = 0
    BrkPedal: int = 0
    AccPedal: int = 0


@dataclasses.dataclass
class AutoStateEx:
    """Extended drive-mode state (AutoStateEx.msg)."""

    header: Header = dataclasses.field(default_factory=Header)
    StateTurningLight: int = 0
    CurDriveMode: int = 0
    StateBraking: int = 0


@dataclasses.dataclass
class EPSStatus:
    """Steering status (EPSStatus.msg): wheel angle/rate [deg, deg/s]
    and column torque [Nm]."""

    header: Header = dataclasses.field(default_factory=Header)
    AngleSpd: float = 0.0
    Angle: float = 0.0
    StrngWhlTorq: float = 0.0


@dataclasses.dataclass
class ESCStatus:
    """Per-wheel speeds [km/h] (ESCStatus.msg)."""

    header: Header = dataclasses.field(default_factory=Header)
    RRWheelSpd: float = 0.0
    LFWheelSpd: float = 0.0
    RFWheelSpd: float = 0.0
    LRWheelSpd: float = 0.0


@dataclasses.dataclass
class RadarObs:
    """Continental radar object (continental_radar_msgs/msg/RadarObs.msg;
    srr/us radar packs are field subsets of this)."""

    clusterortrack: bool = False   # 0 = track, 1 = cluster
    obstacle_id: int = 0
    longitude_dist: float = 0.0    # +forward [m]
    lateral_dist: float = 0.0      # +left [m]
    longitude_vel: float = 0.0     # [m/s]
    lateral_vel: float = 0.0
    rcs: float = 0.0               # [dBsm]
    dynprop: int = 4               # 0 moving .. 7 stopped (4 unknown)
    probexist: float = 0.0
    meas_state: int = 0
    longitude_accel: float = 0.0
    lateral_accel: float = 0.0
    oritation_angle: float = 0.0   # [deg] (sic — reference spelling)
    length: float = 0.0
    width: float = 0.0
    obstacle_class: int = 7        # 7 = unknown


@dataclasses.dataclass
class InsPva:
    """Novatel INS position/velocity/attitude (InsPva.msg)."""

    header: Header = dataclasses.field(default_factory=Header)
    gps_week: int = 0
    gps_seconds: float = 0.0
    latitude: float = 0.0          # [deg]
    longitude: float = 0.0         # [deg]
    height: float = 0.0            # WGS84 ellipsoidal [m]
    north_velocity: float = 0.0    # [m/s]
    east_velocity: float = 0.0
    up_velocity: float = 0.0
    roll: float = 0.0              # [deg]
    pitch: float = 0.0
    azimuth: float = 0.0           # left-handed about z [deg]
    status: int = 0


@dataclasses.dataclass
class GpChc:
    """CHC integrated-navigation sentence (GpChc.msg)."""

    header: Header = dataclasses.field(default_factory=Header)
    chc_header: str = "$GPCHC"
    gps_week: int = 0
    gps_time: float = 0.0
    heading: float = 0.0
    pitch: float = 0.0
    roll: float = 0.0
    gyro_x: float = 0.0
    gyro_y: float = 0.0
    gyro_z: float = 0.0
    acc_x: float = 0.0
    acc_y: float = 0.0
    acc_z: float = 0.0
    latitude: float = 0.0
    longitude: float = 0.0
    altitude: float = 0.0
    ve: float = 0.0
    vn: float = 0.0
    vu: float = 0.0
    speed: float = 0.0
    nsv1: int = 0
    nsv2: int = 0
    status: int = 0
