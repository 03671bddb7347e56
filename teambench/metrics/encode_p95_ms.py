"""`encode_p95_ms`: the 95th percentile of the window's batches, each timed by
events on the stream from its start to its end."""


def read(r):
    return r.latency_quantile_ms(95)
