"""Per superblock, the fleet engine call (FleetEngine.process_packed2)
less the typed FEC inside it: C++ burst sync, RM(30,14), the MAC
dispatch and their Python glue, in host ms."""


def read(run):
    if not run.calls.get("engine"):
        return None
    return (run.host_s["engine"] - run.host_s.get("fec", 0.0)) \
        / run.superblocks * 1e3
