"""`attn.device_ms`: device milliseconds a batch of the kernel families of
the `attention kernels` layer, in the traced window."""


def read(r):
    return r.layer_ms("attention kernels")
