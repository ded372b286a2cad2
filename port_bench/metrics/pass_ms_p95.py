"""The 95th percentile (linear interpolation) of every pass of the window,
each timed from its call to its synchronize: the refresh time a
progressive viewer sees."""
import numpy as np


def read(rec):
    return float(np.percentile(rec["pass_s"], 95)) * 1e3
