"""Mean ms of the loader's ``data.collate`` spans (its worker thread) that
closed in the traced stretch."""

from portbench.core.program import collate_ms as read  # noqa: F401
