"""`runtime.host_ms`: the host's milliseconds in one `encode_image` call,
each dispatched on an idle device (so no full launch queue blocks it), mean
over the traffic's `trace.host_batches`."""


def read(r):
    return r.host_ms
