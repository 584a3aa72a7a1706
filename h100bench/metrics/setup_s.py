"""setup_s: seconds from the process's start to the window's start (the
library load or build, the target, the captures and the warm horizon)."""


def read(run):
    return run.setup_s
