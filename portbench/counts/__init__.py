"""Model operation counts, one module a family, taken from the
configuration's layer shapes as published, whatever the program runs.

A configuration names its module in ``portbench.counts``. The module
gives ``forward_flops(config, samples)``, the generator's forward for
``samples`` output samples, and, where the family has a training cell,
``train_step_flops(config, batch, samples)``, one training step at
``batch`` windows of ``samples``. A later family is a new module and a
new key in its configuration, with no edit here.
"""
