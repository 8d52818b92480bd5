"""images_per_s: images of the whole steps or batches completed in the
window over the window's time (host clock, ended by a synchronize)."""


def read(run):
    if run.work.unit != "images":
        return None
    return run.window.units / run.window.seconds
