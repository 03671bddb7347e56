"""`tower.elementwise_ms`: device milliseconds a batch of the kernels that are
neither GEMM nor attention (layer norms, adds, casts, GELU, int8 epilogues and
quantize producers): the kernel families of that layer, in the traced window."""


def read(r):
    return r.layer_ms("tower elementwise and int8 epilogues")
