"""The port's serving launcher (repro_torch.launch.serve) against the
reference's (repro.launch.serve), both on the CPU: the same flags give the
same admission decisions (the REJECTED lines), the same report keys per
admitted stream and the same completed-request count; the report's
latencies are finite and ordered (p50 <= p99)."""

import re

import numpy as np
import pytest

from repro.launch import serve as jserve
from repro_torch.launch import serve


def _summary(out: str):
    rejected = sorted(re.findall(r"^(stream\d+): REJECTED \((.*)\)$", out,
                                 re.M))
    completed = re.findall(r"^server completed (\d+) requests", out, re.M)
    return rejected, completed


@pytest.mark.parametrize("flags", [
    [],
    ["--streams", "2", "--requests", "1", "--steps", "4", "--ordering",
     "fifo"],
    ["--streams", "4", "--requests", "1", "--steps", "3", "--ordering",
     "edf"],
])
def test_launcher_matches_the_reference(flags, capsys):
    want = jserve.main(flags)
    want_out = capsys.readouterr().out
    got = serve.main(flags + ["--device", "cpu"])
    got_out = capsys.readouterr().out
    assert _summary(got_out) == _summary(want_out)
    assert sorted(got) == sorted(want) and got
    for name, rep in got.items():
        assert sorted(rep) == sorted(want[name])
        assert all(np.isfinite(v) and v >= 0 for v in rep.values())
        assert rep["decode_p50_ms"] <= rep["decode_p99_ms"]
