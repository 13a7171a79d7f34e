"""card_wait_ms_per_step.lockstep: milliseconds the lockstep engine's host
waits for the card (its "card_wait" phase inside "writeback" and
"winner_fetch": the synchronize on each event's copy to the host) per CTU
step, over the window. The enclosing phases' self time is the host's
copies into the engine's buffers. None where the program keeps no such
phase."""


def read(readings):
    w = readings["window"]
    t = w["phases"].get("card_wait")
    steps = w.get("ctu_steps")
    return 1e3 * t / steps if t and steps else None
