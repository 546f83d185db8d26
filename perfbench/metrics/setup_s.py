"""Set-up: from the process's start to the window's: imports, the card's
initialisation, the kernels' build (the first run in a checkout), the
weights drawn and one warm batch at each prompt length."""


def read(run):
    return run.setup_s
