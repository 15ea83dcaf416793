"""Per superblock, the typed FEC (rx.fec.decode_rows_typed_packed),
uploads and fetches included, in host ms."""


def read(run):
    if not run.calls.get("fec"):
        return None
    return run.host_s["fec"] / run.superblocks * 1e3
