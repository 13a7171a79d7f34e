"""image_ms_p50: median milliseconds of one call, from the call to its
streams, over every call of the window that returned."""
from benchmark.harness import percentile


def read(readings):
    lat = readings["window"]["latencies_s"]
    return 1e3 * percentile(lat, 50) if lat else None
