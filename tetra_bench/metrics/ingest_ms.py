"""Host feed only: per superblock, the wall of process_wideband calls
outside _superblock (numpy framing, window stacking, upload), in ms."""


def read(run):
    if not run.calls.get("ingest"):
        return None
    return (run.host_s["ingest"] - run.host_s.get("superblock", 0.0)) \
        / run.superblocks * 1e3
