"""cluster_rounds.device: `cluster_rounds` in the cells whose end-to-end
time is the card's, `frame_device_ms`: each round is a launch and card
time."""

from portbench.harness import load_metric

_base = load_metric("cluster_rounds")
COUNTS = _base.COUNTS
read = _base.read
