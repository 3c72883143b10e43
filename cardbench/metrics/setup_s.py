"""setup_s: seconds from the process's start to the window's, all set-up
included (imports, the kernels' library, weights and frames made on the
card, the gate's calibration, the warm-up)."""


def read(r):
    return r.setup_s
