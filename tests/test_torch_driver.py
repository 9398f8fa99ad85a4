"""The port's driver codecs (``dcarl_tpu_torch/driver``) against the JAX
package's (``dcarl_tpu/driver``): every case of
``tests/test_driver_msgs.py`` run through both, CAN payloads, GPCHC
sentences and decoded fields equal, the ENU pose and the radar arrays
bit-equal."""

import dataclasses
import math

import numpy as np
import pytest

import dcarl_tpu.driver as J
import dcarl_tpu_torch.driver as P
from dcarl_tpu.driver.messages import InsPva as JInsPva
from dcarl_tpu_torch.driver.messages import InsPva as PInsPva

CAN_CASES = [
    ("AutoCtlReq", dict(AutoMode=1, VoiceAlarm=2, TarSpeedReq=35.5,
                        EPSAngleReq=-123.4, TurnLight=1)),
    ("AutoState", dict(EPBState=1, GearState=4, BrkPedal=0, AccPedal=37)),
    ("AutoStateEx", dict(StateTurningLight=2, CurDriveMode=1,
                         StateBraking=1)),
    ("EPSStatus", dict(AngleSpd=-55.3, Angle=470.1, StrngWhlTorq=1.25)),
    ("ESCStatus", dict(RRWheelSpd=33.33, LFWheelSpd=34.01, RFWheelSpd=0.0,
                       LRWheelSpd=120.55)),
]


def _fields(msg) -> dict:
    return dataclasses.asdict(msg)


@pytest.mark.parametrize("name,kw", CAN_CASES, ids=[c[0] for c in CAN_CASES])
def test_can_roundtrip_matches_jax(name, kw):
    jm, pm = getattr(J, name)(**kw), getattr(P, name)(**kw)
    jid, jpay = J.encode_frame(jm)
    pid, ppay = P.encode_frame(pm)
    assert (pid, ppay) == (jid, jpay) and len(ppay) == 8
    jback = J.decode_frame(jid, jpay, stamp=1.5)
    pback = P.decode_frame(pid, ppay, stamp=1.5)
    assert type(pback).__name__ == name
    assert _fields(pback) == _fields(jback)
    assert pback.header.stamp == 1.5
    # test_driver_msgs.py's own tolerance on the round trip
    for field in kw:
        assert abs(getattr(pback, field) - kw[field]) <= 0.05, field
    assert P.CAN_IDS[type(pm)] == J.CAN_IDS[type(jm)]


def test_can_unknown_id_and_bad_payload():
    for pkg in (J, P):
        with pytest.raises(KeyError):
            pkg.decode_frame(0x999, b"\x00" * 8)
        with pytest.raises(ValueError):
            pkg.decode_frame(0x110, b"\x00" * 7)


def test_gpchc_roundtrip_and_checksum_match_jax():
    kw = dict(gps_week=2200, gps_time=345678.25, heading=92.5, pitch=1.25,
              roll=-0.75, latitude=39.99900111, longitude=116.32645222,
              altitude=43.3, ve=1.5, vn=-0.25, vu=0.01, speed=1.52,
              nsv1=18, nsv2=17, status=42)
    s = P.gpchc_sentence(P.GpChc(**kw))
    assert s == J.gpchc_sentence(J.GpChc(**kw))
    assert s.startswith("$GPCHC,") and "*" in s
    back = P.parse_gpchc(s, stamp=2.0)
    assert _fields(back) == _fields(J.parse_gpchc(s, stamp=2.0))
    assert back.gps_week == 2200 and back.status == 42
    assert back.latitude == pytest.approx(39.99900111)
    bad = s[:-2] + ("00" if s[-2:] != "00" else "11")
    for pkg in (J, P):
        with pytest.raises(ValueError):
            pkg.parse_gpchc(bad)
    # without a checksum the sentence still parses
    assert _fields(P.parse_gpchc(s.split("*")[0])) \
        == _fields(J.parse_gpchc(s.split("*")[0]))


def test_geodetic_to_enu_is_bit_equal():
    lat0, lon0, h0 = 40.0, 116.3, 50.0
    rng = np.random.default_rng(0)
    cases = [(lat0 + 0.001, lon0, h0), (lat0, lon0 + 0.001, h0),
             (lat0, lon0, h0 + 5.0)]
    cases += [tuple(x) for x in np.c_[lat0 + rng.normal(0, 0.01, 20),
                                      lon0 + rng.normal(0, 0.01, 20),
                                      h0 + rng.normal(0, 3, 20)]]
    for lat, lon, h in cases:
        got = P.geodetic_to_enu(lat, lon, h, lat0, lon0, h0)
        assert got == J.geodetic_to_enu(lat, lon, h, lat0, lon0, h0)
    e, n, u = P.geodetic_to_enu(lat0 + 0.001, lon0, h0, lat0, lon0, h0)
    assert abs(e) < 0.5 and n == pytest.approx(111.0, rel=0.01)


def test_pose_from_inspva_is_bit_equal():
    origin = (40.0, 116.3, 50.0)
    for az in (0.0, 90.0, 181.5, -45.0, 359.9):
        kw = dict(latitude=40.0003, longitude=116.3002, height=51.0,
                  north_velocity=2.0, east_velocity=1.0, up_velocity=0.1,
                  azimuth=az)
        got = P.pose_from_inspva(PInsPva(**kw), origin)
        assert got == J.pose_from_inspva(JInsPva(**kw), origin)
    p = P.pose_from_inspva(PInsPva(latitude=40.0, longitude=116.3,
                                   height=50.0, azimuth=0.0), origin)
    assert p["yaw"] == pytest.approx(math.pi / 2)


@pytest.mark.parametrize("kw", [
    dict(max_slots=4), dict(max_slots=4, drop_stationary=True),
    dict(max_slots=1, sensor_pose=(1.0, 0.0, math.pi / 2)),
    dict(max_slots=2, min_probexist=0.1, sensor_pose=(0.5, -0.2, 0.3))])
def test_radar_ingestion_is_bit_equal(kw):
    objs = [
        dict(obstacle_id=1, longitude_dist=20.0, lateral_dist=0.0,
             longitude_vel=-3.0, probexist=0.9, dynprop=0),
        dict(obstacle_id=2, longitude_dist=5.0, lateral_dist=2.0,
             longitude_vel=0.0, probexist=0.8, dynprop=1),
        dict(obstacle_id=3, longitude_dist=10.0, lateral_dist=-1.0,
             probexist=0.2, dynprop=0, oritation_angle=12.5),
        dict(longitude_dist=2.0, lateral_vel=0.7, probexist=1.0),
    ]
    jr, jv = J.radar_to_tracked_arrays([J.RadarObs(**o) for o in objs], **kw)
    pr, pv = P.radar_to_tracked_arrays([P.RadarObs(**o) for o in objs], **kw)
    assert isinstance(pr, np.ndarray) and pr.dtype == jr.dtype
    np.testing.assert_array_equal(pr, jr)
    np.testing.assert_array_equal(pv, jv)
    assert pv.sum() >= 1
