"""Set-up: from process start to the first timed call (import, kernel
build, data, weights, warm-up and, in training, the checked first
steps)."""


def read(run):
    return run["setup_s"]
