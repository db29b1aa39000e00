"""Decode tokens completed in the window, of any job, over the window's
seconds."""

from harness import readers as R


def read(run):
    n = len(R.decode_tokens_in_window(run))
    return n / (run.host_end - run.w0) if n else None
