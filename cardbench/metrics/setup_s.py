"""Seconds from the process's start to the window's: imports, the kernels' load (their build on a checkout's first run), weights, images, set-up work of the mix, warm-up."""

def read(r):
    return r.setup_s
