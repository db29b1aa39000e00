"""Device: share of the traced sub-window's device-idle time during which
a server thread was in a call's host step ("stage", "readback" or
"insert" span of the program), in %."""

from harness import spans as SP


def read(run):
    return SP.idle_share_in(run, ("stage", "readback", "insert"))
