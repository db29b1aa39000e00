"""Faults planted under the timed path, to show that ``correct`` catches
them: each is a ``fault(eng, rec)`` that ``driver.setup`` applies once the
benchmark's wrappers are on, before the cells are precompiled (so a
captured graph holds the fault too).  One card: there is no exchange
between cards to leave out."""

from __future__ import annotations

import numpy as np


def altered_token(eng, rec):
    """Row 0 of every decode call serves the token it ranks last."""
    def fault(payloads, rows):
        rows = [r.copy() for r in rows]
        rows[0][int(np.argmin(rows[0]))] = rows[0].max() + 1.0
        return rows
    rec.fault = fault


def half_batch(eng, rec):
    """Each decode call computes only the first half of its rows (rounded
    down); the others get the first row's answer, or none."""
    def fault(payloads, rows):
        keep = len(rows) // 2
        fill = rows[0] if keep else np.zeros_like(rows[0])
        return rows[:keep] + [fill] * (len(rows) - keep)
    rec.fault = fault


def state_unchanged(eng, rec):
    """Every decode step writes its new token's cache into copies of the
    pools: the pools stay as the prefill left them."""
    impl = eng._decode_paged_impl

    def decode(packed, pools, params=None):
        copy = {k: tuple(t.clone() for t in v) for k, v in pools.items()}
        return impl(packed, copy, params)
    eng._decode_paged_impl = decode


FAULTS = {f.__name__: f for f in (altered_token, half_batch, state_unchanged)}
