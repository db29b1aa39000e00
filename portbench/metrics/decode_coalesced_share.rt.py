"""Dispatch layer: mean over the traced sub-window's decode calls of their
rows over the server's streams in their decode loop when the call began
(``batch_meta`` ``decoding``), in %: the decode rows a call left out."""

from harness import spans as SP


def read(run):
    return SP.coalesced_share(run)
