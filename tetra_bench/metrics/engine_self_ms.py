"""Host ms a superblock in FleetEngine.process_packed2 outside its native
feed, its FEC passes and its dispatch: the engine's Python glue (row
sort, keystream map, SB1 adoption, fleet_rm_redecode, voice callbacks);
the program's engine span less engine.feed, fec and engine.dispatch."""

from tetra_bench import program_spans


def read(run):
    return program_spans.mean_ms(run, "engine",
                                 ("engine.feed", "fec", "engine.dispatch"))
