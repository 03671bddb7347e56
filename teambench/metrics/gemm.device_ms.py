"""`gemm.device_ms`: device milliseconds a batch of the kernel families of
the `tower GEMMs` layer, in the traced window."""


def read(r):
    return r.layer_ms("tower GEMMs")
