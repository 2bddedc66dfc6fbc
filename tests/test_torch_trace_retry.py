"""`time_kernels.kernel_times` takes a trace only if it holds every launch
and its device time is at most `TRACE_SLACK` times its events time, and
traces again otherwise. The traces are stood in for here (the profiler's
device time needs a card); the card's own readings are
`tools/trace_check.py`'s."""

from __future__ import annotations

import pytest

from omniisaacgymenvs_torch.scripts import time_kernels as tk

REPS = 20


@pytest.fixture
def traces(monkeypatch):
    """Feeds kernel_times the given (launches, device ms, events ms) traces
    in turn; returns the list of traces taken and the pads they waited."""
    taken = []

    def feed(seq):
        it = iter(seq)

        def trace_once(fn, reps, durations=False):
            assert reps == REPS
            taken.append(tk.TRACE_PAD_S[0])
            n, d, w = next(it)
            return n, d, w, None

        monkeypatch.setattr(tk, "trace_once", trace_once)
        return taken

    monkeypatch.setattr(tk.torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(tk, "TRACE_PAD_S", [0.1])
    return feed


@pytest.mark.parametrize("seq, picked, n_traces, pads", [
    # the first trace counts
    ([(REPS, 0.0576, 0.0589)], (0.0576, 0.0589), 1, [0.1]),
    # a trace past the slack (the reading of a refused chip_smoke.py run)
    # is taken again, at the same pad
    ([(REPS, 0.0689, 0.0589), (REPS, 0.0576, 0.0589)], (0.0576, 0.0589), 2,
     [0.1, 0.1]),
    # a lost launch lengthens the pad, then a trace past the slack does not
    ([(REPS - 2, 0.05, 0.06), (REPS, 0.07, 0.06), (REPS, 0.058, 0.06)],
     (0.058, 0.06), 3, [0.1, 0.4, 0.4]),
    # exactly at the slack counts
    ([(REPS, tk.TRACE_SLACK * 0.05, 0.05)], (tk.TRACE_SLACK * 0.05, 0.05), 1,
     [0.1]),
])
def test_kernel_times_takes_the_first_trace_that_counts(traces, seq, picked,
                                                        n_traces, pads):
    taken = traces(seq)
    assert tk.kernel_times(lambda: None, REPS) == picked
    assert len(taken) == n_traces
    assert taken == pytest.approx(pads)


@pytest.mark.parametrize("seq, match", [
    ([(REPS, 0.0689, 0.0589)] * 4, "no trace of 20 launches counted"),
    ([(REPS, 0.0, 0.0589)] * 4, "no trace of 20 launches counted"),
    ([(REPS + 1, 0.05, 0.06), (REPS, 0.05, 0.06)], r"\(21, 0.05, 0.06\)"),
])
def test_kernel_times_raises_without_a_trace_that_counts(traces, seq, match):
    taken = traces(seq)
    with pytest.raises(RuntimeError, match=match):
        tk.kernel_times(lambda: None, REPS)
    # a trace with more launches than fn made ends the search at once
    assert len(taken) == (1 if seq[0][0] > REPS else 4)
