"""setup_s: seconds from the process's start to the window's first step
or call (host clock): imports, the kernel libraries' build or load, the
weights and traffic drawn on the card, the checked and warm-up steps."""


def read(run):
    return run.setup_s
