"""Set-up: from the start of the process to the opening of the window
(loading, weights and experts made from the seed, kernels built or
loaded, warm-up and graph captures), host clock."""


def read(rec):
    return rec.setup_s
