"""The whole window's share of the chip's float32 peak: the operations
of every K1, K2 and K3 launch of the window (roofline.py's counts) over
the traced window's seconds times the peak, in percent."""

from portbench import roofline


def read(run):
    ops = sum(run.work.get(k, {}).get("ops", 0.0) for k in ("k1", "k2", "k3"))
    if run.trace is None or ops <= 0 or run.window_s <= 0:
        return None
    return 100.0 * ops / (run.window_s * roofline.PEAK_F32_FLOPS)
