"""Per traced call, the time inside the harness's span around the serving
call when no kernel, copy or memset ran on the card (host preparation,
transfers, waits, the crop); the mean over the traced calls, in ms."""

from portbench.core.readers import api_exposed_ms as read  # noqa: F401
