"""step_latency_p95_ms: the 95th percentile (numpy's linear interpolation)
over every dispatch completed inside the window, from its images handed to
the upload to its packed block on the host."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.latencies_ms, np.float64), 95))
