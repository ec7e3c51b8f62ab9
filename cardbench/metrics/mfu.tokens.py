"""The model's operations over the window (every served prompt token and
fed-back generated token, 2 per weight passed and 4 * heads * head size
per attended position and layer), as a share of the bf16 peak of 989
TFLOP/s."""

from cardbench.lib import layers


def read(rec):
    return layers.mfu(rec)
