"""train_img_per_s: every image of every step in the window over the
window's seconds (host clock, the window closed by a synchronize)."""


def read(run):
    if run.family != "train":
        return None
    return run.images / run.seconds
