"""qps: queries completed in the window over the window's seconds (host
clock; the window ends when the call that crosses ``--seconds``
returns)."""


def read(run):
    return run.completed / run.window_s
