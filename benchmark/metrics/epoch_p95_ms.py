"""The 95th percentile of the window's epoch times, each taken between two
CUDA events recorded on the stream at the epoch's boundaries."""

import numpy as np


def read(rec):
    times = rec["window"]["epoch_times_ms"]
    return float(np.percentile(times, 95)) if times else None
