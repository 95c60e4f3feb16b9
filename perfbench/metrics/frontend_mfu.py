"""The whole window's share of the card's float32 peak (%): the FLOPs the
frames and pairs completed in the traced run's clean session need by the
configuration's shapes (``yardstick.frame_flops``, ``pair_flops``), over
that session's seconds."""
from ._common import mfu


def read(r):
    return mfu(r)
