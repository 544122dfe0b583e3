"""frame_wall_ms: `frame_ms` in a traced run's window, per layer, in the
cells where the host's speed moves the window's wall time too far between
runs to hold a bound; their end-to-end time is `frame_device_ms`."""

from portbench.harness import load_metric

read = load_metric("frame_ms").read
