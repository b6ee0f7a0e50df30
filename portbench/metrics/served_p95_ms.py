"""95th percentile of the request latency, in ms: from ``submit`` to the
client's ``result()``, over every request of the window (numpy's linear
interpolation between order statistics)."""
import numpy as np


def read(ctx):
    lat = [a.latency_s for a in ctx.window.answers if a.latency_s is not None]
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat) * 1e3, 95))
