"""``setup_s``: seconds from the start of the process to the first timed
request (imports, CUDA start, loading the kernels, generating the
operator and the operands, the program's plan and pack, warm-up)."""


def read(rec):
    """The run's set-up time."""
    return rec.setup_s
