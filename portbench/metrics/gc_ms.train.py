"""Per traced step, the ms of Python's garbage collections (the program's
``host.gc`` spans, on any thread) in the traced stretch."""

from portbench.core import program


def read(run):
    return program.per_step_ms(run, "host.gc", main_thread=False)
