"""arbiter_ms_per_step.lockstep: milliseconds of the lockstep engine's host
arbiters (encode_batch's "host_arbiter" phase: the wait in
hevce_batch_next while the C++ workers consume the last event's results,
trial-encode and rendezvous at the next event) per CTU step, over the
window."""


def read(readings):
    w = readings["window"]
    t = w["phases"].get("host_arbiter")
    steps = w.get("ctu_steps")
    return 1e3 * t / steps if t and steps else None
