"""The demod's share of its roofline, in %: the least time of the blocks'
K1 and lean-K2 work (tetra_bench.work, counted by shape) over the device
time of every kernel launched while the harness's demod range was open,
in the traced stretch."""

from tetra_bench import work


def read(run):
    dev = run.spans.get("span_device_s", {}).get("bench.demod")
    calls = run.spans.get("span_calls", {}).get("bench.demod")
    if not dev or not calls:
        return None
    least = calls * work.demod_ms(run.carriers, run.t36) / 1e3
    return 100.0 * least / dev
