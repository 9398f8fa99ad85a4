"""Seconds of ``fill_lane_store``, which fills the lane fleet's store in
set-up, on the harness's clock, from the call to the device's end of
it."""


def read(m):
    return m.get("spans", {}).get("store_fill_s")
