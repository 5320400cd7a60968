"""setup_s: seconds from the process's start to the window's: imports, the
CUDA context, loading (at a checkout's first run, building) the kernel
libraries, the inputs drawn and staged on the card, and the warm-up."""


def read(run):
    return run.setup_s
