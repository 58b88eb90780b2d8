"""setup_s: process start to the first timed request: the CUDA context, the
problem's files, the kernel's library (built with nvcc in a checkout's
first run), the pool of views and the warm-up round."""


def read(run):
    return run.setup_s
