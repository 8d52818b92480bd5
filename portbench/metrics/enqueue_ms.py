"""enqueue_ms.<cell kind>: host ms from a unit's call to its return, no
synchronize, mean over the measured window's units (the step dispatch
layer: launch/steps.py or train/loop.py, autograd, the kernels'
launches; a call that waits on the device counts its wait)."""


def read(run):
    e = run.window.enqueue_s
    return 1e3 * sum(e) / len(e)
