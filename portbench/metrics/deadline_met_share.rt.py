"""Admission layer: share of the jobs released in the window (failed and
unfinished ones included) whose last token came by release + deadline
(%), from the benchmark's request timestamps."""

from harness import readers as R


def read(run):
    return R.deadline_met_share(run)
