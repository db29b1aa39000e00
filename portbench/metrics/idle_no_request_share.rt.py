"""Device: share of the traced sub-window's device-idle time during which
no "request" span of the program was open on any server -- the card waits
on the clients -- in %."""

from harness import spans as SP


def read(run):
    return SP.idle_share_in(run, ("request",), inside=False)
