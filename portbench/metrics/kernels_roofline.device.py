"""kernels_roofline.device: `kernels_roofline` in the cells whose
end-to-end time is the card's, `frame_device_ms`."""

from portbench.harness import load_metric

read = load_metric("kernels_roofline").read
