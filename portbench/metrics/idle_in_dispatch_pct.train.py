"""The share of the traced stretch's device-idle time (no kernel, copy or
memset on the card) that lies under the train step's own phase spans
(``step.*``, on the step's thread), in %."""

from portbench.core.program import idle_in_dispatch_pct as read  # noqa: F401
