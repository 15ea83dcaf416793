"""Host ms a superblock in the fleet engine's native MAC dispatch (the
program's engine.dispatch span around fleet_dispatch)."""

from tetra_bench import program_spans


def read(run):
    return program_spans.mean_ms(run, "engine.dispatch")
