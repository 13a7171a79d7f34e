"""setup_s: seconds from the start of the process until the window opens
(the port's builds, the pool of images, the warm-up calls that capture the
slice runners)."""


def read(readings):
    return readings["setup_s"]
