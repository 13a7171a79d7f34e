"""image_ms_p90: the 90th percentile (nearest rank) of the same times."""
from benchmark.harness import percentile


def read(readings):
    lat = readings["window"]["latencies_s"]
    return 1e3 * percentile(lat, 90) if lat else None
