"""train_images_per_s: real training images the feed delivered over the
whole window, divided by the window (host clock, the device synchronised
at its end). A GAN cycle counts (n_critic + 1) x batch; an encoder step its
batch of real images."""

from hgbench import stats


def read(run):
    if "images" not in run.counters:
        return None
    return stats.rate(run.counters["images"], run.window_s)
