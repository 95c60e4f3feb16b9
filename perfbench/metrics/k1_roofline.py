"""K1's share of its roofline (%): per launch the larger of the bytes it
must move over the card's HBM rate and its float32 operations over the
float32 peak (``yardstick.k1_bytes``, ``yardstick.k1_ops``), over the
kernel's device time per launch in the profiler's trace."""
from ._common import roofline


def read(r):
    return roofline(r, "keypoint_score_kernel", "k1")
