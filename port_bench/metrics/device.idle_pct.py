"""device.idle_pct: the share of the traced stretch (first step span's
start to the last's end) in which no operation ran on the card."""


def read(run):
    t = run.timeline
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
