"""Host ms a superblock in the fleet engine's native feed (the
program's engine.feed span around fleet_feed_sb: C++ burst sync over
every carrier, the BBK RM(30,14) decode, worker start and join)."""

from tetra_bench import program_spans


def read(run):
    return program_spans.mean_ms(run, "engine.feed")
