"""`attn.roofline_pct`: the bound of the attention's work (`work.attention`
at the config's attention operand precision) over the `attention kernels`
layer's time, in percent."""


def read(r):
    return r.roofline_pct("attention kernels")
