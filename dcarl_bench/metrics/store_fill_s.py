"""Seconds of the trainer run that fills the gated fleet's store, on the
harness's clock, from the call to the device's end of it."""


def read(m):
    return m.get("spans", {}).get("store_fill_s")
