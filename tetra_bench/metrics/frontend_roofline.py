"""The front end's share of its roofline, in %: the least time of the
blocks' front-end work (tetra_bench.work, K3 counted by shape) over the
device time of every kernel launched while the harness's front-end range
was open, in the traced stretch."""

from tetra_bench import work


def read(run):
    dev = run.spans.get("span_device_s", {}).get("bench.frontend")
    calls = run.spans.get("span_calls", {}).get("bench.frontend")
    if not dev or not calls:
        return None
    least = calls * work.frontend_ms(run.carriers, run.t50, run.t36) / 1e3
    return 100.0 * least / dev
