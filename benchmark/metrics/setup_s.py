"""Process start to the first timed cycle: imports, the kernel build or
load, the cluster, the set-up burst and the warm-up waves."""


def read(run):
    return run.setup_s
