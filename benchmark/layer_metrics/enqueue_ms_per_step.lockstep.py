"""enqueue_ms_per_step.lockstep: host milliseconds of the lockstep engine's
event dispatch (its "device_math_node8/16/32" and "device_math_pu" phases:
each event's request rows loaded into its program and the program's graph
replay queued) per CTU step, over the window."""


def read(readings):
    w = readings["window"]
    t = sum(v for k, v in w["phases"].items()
            if k.startswith("device_math_"))
    steps = w.get("ctu_steps")
    return 1e3 * t / steps if t and steps else None
