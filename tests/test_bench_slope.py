"""Unit tests for bench.py's regression-slope estimator.

The estimator is the artifact of record's foundation (every recorded
perf number is one of these slopes), so its statistical behavior is
tested directly with synthetic timing generators — no device needed.
Covers the two failure modes seen in real timing runs:

  * isolated stalls (a ~200 ms burst in one batch) must be absorbed by
    the per-length median without moving the slope;
  * majority contamination (most of one length's batches stalled, which
    pollutes the median itself) must trigger the stall-retry — more
    batches are ADDED (never discarded) until the leave-one-out
    uncertainty drops below slope/4 or the retry budget is exhausted.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench import _lsq, _slope  # noqa: E402


TRUE_MS = 0.4
FIXED_MS = 15.0
LENGTHS = (20, 60, 100)


def _clean(n):
    return FIXED_MS + TRUE_MS * n


def test_lsq_exact_affine():
    b, a = _lsq([20, 60, 100], [_clean(20), _clean(60), _clean(100)])
    assert abs(b - TRUE_MS) < 1e-9
    assert abs(a - FIXED_MS) < 1e-9


def test_slope_clean_batches_no_retry():
    slope, diag = _slope(lambda n: [_clean(n)] * 6, LENGTHS)
    assert abs(slope - TRUE_MS) < 1e-9
    assert diag["retries"] == 0
    assert diag["unc_ms"] < 1e-9
    # every raw batch is in the artifact
    assert all(len(diag["batches_ms"][str(n)]) == 6 for n in LENGTHS)


def test_slope_isolated_stall_absorbed_by_median():
    def time_at(n):
        bs = [_clean(n)] * 6
        bs[0] += 200.0  # one stalled batch per length
        return bs

    slope, diag = _slope(time_at, LENGTHS)
    assert abs(slope - TRUE_MS) < 1e-9
    assert diag["retries"] == 0


def test_slope_majority_stall_triggers_retry_and_recovers():
    calls = {n: 0 for n in LENGTHS}

    def time_at(n):
        calls[n] += 1
        if calls[n] == 1 and n == LENGTHS[0]:
            # first visit to the short ladder: 4-of-6 stalled (the
            # live failure: median polluted, slope garbage)
            return [_clean(n) + 200.0] * 4 + [_clean(n)] * 2
        return [_clean(n)] * 6

    slope, diag = _slope(time_at, LENGTHS)
    assert diag["retries"] >= 1
    # after the retry the short length has 2 clean-majority rounds:
    # 6 stalled-heavy + 6 clean = median back on the clean side
    assert abs(slope - TRUE_MS) < 0.02
    assert diag["unc_ms"] < 0.25 * slope + 1e-9
    # nothing was discarded: the contaminated batches are still visible
    n0 = str(LENGTHS[0])
    assert len(diag["batches_ms"][n0]) == 12
    assert max(diag["batches_ms"][n0]) > 200.0


def test_slope_persistent_noise_reports_honest_uncertainty():
    """A generator that is ALWAYS noisy must exhaust the retry budget and
    still report a large unc_ms — the retry adds data, it cannot launder
    a genuinely unstable measurement into a tight error bar."""
    state = {"k": 0}

    def time_at(n):
        out = []
        for _ in range(6):
            state["k"] += 1
            noise = 150.0 if state["k"] % 2 == 0 else 0.0
            out.append(_clean(n) + noise)
        return out

    slope, diag = _slope(time_at, LENGTHS)
    assert diag["retries"] == 2  # budget exhausted
    assert diag["unc_ms"] > 0.25 * slope  # honest, still-large error bar


def test_slope_retry_not_triggered_by_proportional_jitter():
    """Small multiplicative jitter (normal timing noise) stays under
    the retry threshold."""
    import random

    rng = random.Random(0)

    def time_at(n):
        return [_clean(n) * (1.0 + 0.01 * rng.random()) for _ in range(6)]

    slope, diag = _slope(time_at, LENGTHS)
    assert diag["retries"] == 0
    assert abs(slope - TRUE_MS) / TRUE_MS < 0.05
