"""Mean over the traced calls of the serving API's ``serve.prepare`` span
inside each (normalize, edge-pad and stack the mels, copy them to the
card, draw the noise), in ms."""

from portbench.core.program import prepare_ms as read  # noqa: F401
