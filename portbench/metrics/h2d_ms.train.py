"""Per traced step, the ms inside the trainer's ``train.h2d`` span: the
batch's copy from pageable host memory to the card, with any wait it makes
on the stream."""

from portbench.core import program


def read(run):
    return program.per_step_ms(run, "train.h2d", main_thread=True)
