"""`gemm.roofline_pct`: the bound of the tower's GEMM work (`work.gemm` at
the config's GEMM precision) over the `tower GEMMs` layer's time, in percent."""


def read(r):
    return r.roofline_pct("tower GEMMs")
