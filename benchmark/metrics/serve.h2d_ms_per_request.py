"""Device milliseconds of host-to-device copies per request (the frames'
upload from the pinned staging buffers)."""


def read(m):
    return m.trace.device_s("htod", "host to device") / m.trace.units * 1e3
