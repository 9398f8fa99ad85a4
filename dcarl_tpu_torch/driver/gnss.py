"""GNSS ingestion: GPCHC sentence codec + geodetic -> local ENU pose.

Covers the capability of the reference's novatel/oxford GNSS driver
packs (novatel_gnss_msgs/msg/GpChc.msg, InsPva.msg) and the
``pose_reporter`` node's job of turning GNSS fixes into the planar pose
the navigation stack consumes (software/src/navigation/pose_reporter).
"""

from __future__ import annotations

import math
from functools import reduce
from typing import Tuple

import numpy as np

from dcarl_tpu_torch.driver.messages import GpChc, InsPva

_WGS84_A = 6378137.0
_WGS84_F = 1.0 / 298.257223563
_WGS84_E2 = _WGS84_F * (2.0 - _WGS84_F)


def _nmea_checksum(body: str) -> int:
    return reduce(lambda a, c: a ^ ord(c), body, 0)


def gpchc_sentence(msg: GpChc) -> str:
    """Serialize a GpChc to its $GPCHC NMEA-style sentence."""
    body = (
        f"GPCHC,{msg.gps_week},{msg.gps_time:.3f},{msg.heading:.3f},"
        f"{msg.pitch:.3f},{msg.roll:.3f},{msg.gyro_x:.4f},{msg.gyro_y:.4f},"
        f"{msg.gyro_z:.4f},{msg.acc_x:.4f},{msg.acc_y:.4f},{msg.acc_z:.4f},"
        f"{msg.latitude:.8f},{msg.longitude:.8f},{msg.altitude:.3f},"
        f"{msg.ve:.3f},{msg.vn:.3f},{msg.vu:.3f},{msg.speed:.3f},"
        f"{msg.nsv1},{msg.nsv2},{msg.status}"
    )
    return f"${body}*{_nmea_checksum(body):02X}"


def parse_gpchc(sentence: str, stamp: float = 0.0) -> GpChc:
    """Parse a $GPCHC sentence (checksum verified when present)."""
    sentence = sentence.strip()
    if not sentence.startswith("$"):
        raise ValueError("not an NMEA sentence")
    if "*" in sentence:
        body, chk = sentence[1:].rsplit("*", 1)
        if int(chk, 16) != _nmea_checksum(body):
            raise ValueError("GPCHC checksum mismatch")
    else:
        body = sentence[1:]
    f = body.split(",")
    if f[0] != "GPCHC" or len(f) < 22:
        raise ValueError("malformed GPCHC sentence")
    m = GpChc(
        gps_week=int(f[1]), gps_time=float(f[2]), heading=float(f[3]),
        pitch=float(f[4]), roll=float(f[5]), gyro_x=float(f[6]),
        gyro_y=float(f[7]), gyro_z=float(f[8]), acc_x=float(f[9]),
        acc_y=float(f[10]), acc_z=float(f[11]), latitude=float(f[12]),
        longitude=float(f[13]), altitude=float(f[14]), ve=float(f[15]),
        vn=float(f[16]), vu=float(f[17]), speed=float(f[18]),
        nsv1=int(f[19]), nsv2=int(f[20]), status=int(f[21]))
    m.header.stamp = stamp
    return m


def geodetic_to_enu(lat: float, lon: float, h: float,
                    lat0: float, lon0: float, h0: float
                    ) -> Tuple[float, float, float]:
    """WGS84 geodetic -> local East/North/Up relative to (lat0, lon0, h0)
    via ECEF (exact, not the flat-earth approximation)."""

    def ecef(lat_d, lon_d, alt):
        lat_r, lon_r = math.radians(lat_d), math.radians(lon_d)
        sl, cl = math.sin(lat_r), math.cos(lat_r)
        n = _WGS84_A / math.sqrt(1.0 - _WGS84_E2 * sl * sl)
        x = (n + alt) * cl * math.cos(lon_r)
        y = (n + alt) * cl * math.sin(lon_r)
        z = (n * (1.0 - _WGS84_E2) + alt) * sl
        return np.array([x, y, z])

    d = ecef(lat, lon, h) - ecef(lat0, lon0, h0)
    lat_r, lon_r = math.radians(lat0), math.radians(lon0)
    sl, cl = math.sin(lat_r), math.cos(lat_r)
    so, co = math.sin(lon_r), math.cos(lon_r)
    east = -so * d[0] + co * d[1]
    north = -sl * co * d[0] - sl * so * d[1] + cl * d[2]
    up = cl * co * d[0] + cl * so * d[1] + sl * d[2]
    return float(east), float(north), float(up)


def pose_from_inspva(msg: InsPva, origin: Tuple[float, float, float]
                     ) -> dict:
    """InsPva -> planar pose dict {x, y, z, yaw, vx, vy} in the local
    ENU frame anchored at ``origin`` (lat, lon, height).  Yaw converts
    the left-handed azimuth (deg clockwise from north, InsPva.msg) to
    the right-handed east-referenced heading the planner uses."""
    x, y, z = geodetic_to_enu(msg.latitude, msg.longitude, msg.height,
                              *origin)
    yaw = math.radians(90.0 - msg.azimuth)
    yaw = (yaw + math.pi) % (2.0 * math.pi) - math.pi
    return {
        "x": x, "y": y, "z": z, "yaw": yaw,
        "vx": msg.east_velocity, "vy": msg.north_velocity,
        "vz": msg.up_velocity, "stamp": msg.header.stamp,
    }
