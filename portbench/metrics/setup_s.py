"""Process start to window start: imports, the kernels' build (first run
in a checkout only), weights, bucket tuning, precompile and capture, and
the warm-up traffic."""


def read(run):
    return run.setup_s
