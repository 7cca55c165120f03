"""Every pod bound in the window over the window's seconds: all the work
of the loop (intake, completions, cycles, collection) and all its time."""


def read(run):
    if run.window_s <= 0:
        return None
    return len(run.binds) / run.window_s
