"""setup_s: seconds from the process's start to the measured window's
start (imports, the kernels' build or load, the weights, the data, the
warm-up and checked units). Host clock."""


def read(run):
    return run.setup_s
