"""Model operations of the audio returned (true lengths, not padding),
counted from the configuration's layer shapes, over the window's wall
time, over the peak of the cell's dtype, in %."""

from portbench.core.readers import mfu_serving as read  # noqa: F401
