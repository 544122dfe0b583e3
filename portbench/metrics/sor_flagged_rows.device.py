"""sor_flagged_rows.device: `sor_flagged_rows` in the cells whose
end-to-end time is the card's, `frame_device_ms`: the rescue's rows are
card time."""

from portbench.harness import load_metric

_base = load_metric("sor_flagged_rows")
COUNTS = _base.COUNTS
read = _base.read
