"""launches_per_frame.device: `launches_per_frame` in the cells whose
end-to-end time is the card's, `frame_device_ms`."""

from portbench.harness import load_metric

read = load_metric("launches_per_frame").read
