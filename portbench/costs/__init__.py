"""The yardstick's arithmetic: the card's peaks, each hand-written
kernel's operations and bytes from the shapes of its calls, and the model
FLOPs of a configuration's unit of work (a downscaled day, a train step)
counted once over the plain reference."""

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit.
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
