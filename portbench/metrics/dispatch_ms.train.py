"""The host's cost of issuing one (G, adv, D) step: per traced step, the
time under the train step's own phase spans (``step.*``, their union on
the step's thread), in ms."""

from portbench.core.program import dispatch_ms as read  # noqa: F401
