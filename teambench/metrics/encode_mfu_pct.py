"""`encode_mfu_pct`: model FLOPs an image (`work.model_flops_per_image`) times
the traced window's images a second, over the dense peak of the config's
GEMM precision, in percent."""

from teambench.work import model_flops_per_image


def read(r):
    if r.busy_s is None or r.peaks is None:
        return None
    return 100.0 * model_flops_per_image(r.shape) * r.img_per_s() / r.peaks[r.precision["peak"]]
