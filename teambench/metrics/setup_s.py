"""`setup_s`: process start to the end of the warm-up (imports, weights, the
image pool, the runtime, an int8 tower's calibration and gate, the kernels'
builds or loads, the warm-up batches)."""


def read(r):
    return r.setup_s
