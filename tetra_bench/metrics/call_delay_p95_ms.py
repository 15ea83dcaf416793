"""95th percentile over the window's superblocks of the time from handing
a superblock's last sample to the receiver until its PDUs are out (the
call's return: these receivers are synchronous), in ms.  The host's
stalls reach this tail, so it is read per layer, beside rt_carriers."""

import numpy as np


def read(run):
    return float(np.percentile(run.delays_s, 95)) * 1e3
