"""`encode_img_per_s`: every image encoded in the window over the window's
seconds (host clock, from the first dispatch to the synchronise after the last)."""


def read(r):
    return r.img_per_s()
