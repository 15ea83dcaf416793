"""Host ms per superblock inside the superblock step
(rx.receiver._wideband_step_scan): front end, demod and packing enqueued
for every cycle of the superblock."""


def read(run):
    if not run.calls.get("step"):
        return None
    return run.host_s["step"] / run.superblocks * 1e3
