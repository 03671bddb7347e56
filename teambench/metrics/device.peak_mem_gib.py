"""`device.peak_mem_gib`: `torch.cuda.max_memory_allocated` over the window
(reset after set-up), in GiB."""


def read(r):
    return r.peak_mem_bytes / 2 ** 30
