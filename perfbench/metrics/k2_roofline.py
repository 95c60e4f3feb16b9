"""K2's share of its roofline (%): per launch the larger of the bytes of
the table planes its own slots name, the slots, offsets and patches
(``yardstick.k2_bytes``) over the HBM rate and its operations over the
float32 peak, over the kernel's device time per launch in the trace."""
from ._common import roofline


def read(r):
    return roofline(r, "patches_kernel", "k2")
