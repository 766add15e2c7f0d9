"""The 95th percentile over all batches of the window of the time from a
batch's due time to its detections on the host (closed loop: due when the
previous batch came back)."""

import numpy as np


def read(rec):
    return 1e3 * float(np.percentile(rec["latencies_s"], 95))
