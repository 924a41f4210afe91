"""setup_s: from the process's start (``run.py``'s first line) to the first
timed step: imports, the frame cache, the checkpoints, the program's kernel
library, the cell's warm-up dispatches."""


def read(run):
    return run.setup_s
