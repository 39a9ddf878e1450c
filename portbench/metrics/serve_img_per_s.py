"""serve_img_per_s: every image of every call in the window over the
window's seconds (host clock; each call ends with its lanes on the
host)."""


def read(run):
    if run.family != "serve":
        return None
    return run.images / run.seconds
