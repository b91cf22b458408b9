"""Share of the traced stretch with no kernel, copy or memset on the card
(the union of their intervals on the profiler's timeline), in %."""

from portbench.core.readers import idle_pct as read  # noqa: F401
