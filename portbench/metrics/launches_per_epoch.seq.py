"""launches_per_epoch.seq: the program's ``hopper_union.LAUNCHES``, summed
over its kernels and over the window, divided by the window's epochs, in
the sequence cells; nothing where no kernel was launched (the CPU twins
count none)."""


def read(run):
    launches = run.counters.get("launches")
    epochs = run.totals.get("epochs")
    if not launches or not epochs:
        return None
    return sum(launches.values()) / epochs
